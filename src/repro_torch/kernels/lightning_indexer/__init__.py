"""K7 lightning-indexer scores: the CUDA wrapper (``kernel.py``), its plain
version (``ref.py``) and the differentiable entry point (``ops.py``)."""
