"""Synthetic corpora and the RL toy tasks (``synthetic.py``), the needle
long-context tasks (``needle.py``) and the prefetching input pipeline
(``pipeline.py``)."""
