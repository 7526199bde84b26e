"""K9 flash attention: the CUDA wrapper (``kernel.py``), its plain version
(``ref.py``) and the model-layout entry point (``ops.py``)."""
