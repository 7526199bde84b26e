"""Paged GQA attention: K1 decode (``kernel.py``), K2 span prefill
(``prefill.py``), the gather oracle (``ref.py``) and dispatch (``ops.py``)."""
