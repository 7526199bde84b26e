"""K10 fused output projection + cross-entropy: the CUDA wrapper
(``kernel.py``), its plain version (``ref.py``) and the (B, S) entry point
(``ops.py``)."""
