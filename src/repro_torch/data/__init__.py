"""Synthetic corpora (``synthetic.py``) and the prefetching input pipeline (``pipeline.py``)."""
