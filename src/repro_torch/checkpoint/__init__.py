"""Checkpoints in the reference's format (``io.py``)."""
