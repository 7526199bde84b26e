"""Paged attention: K1/K3 decode (``kernel.py``: GQA, absorbed MLA), K2/K4
span prefill (``prefill.py``), the gather oracles (``ref.py``) and
dispatch (``ops.py``)."""
