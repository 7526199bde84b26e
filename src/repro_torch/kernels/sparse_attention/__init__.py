"""K8 block-sparse attention: the CUDA wrapper and its plain version
(``kernel.py``), the Pallas kernel's oracle (``ref.py``) and the Pallas
kernel's entry point (``ops.py``)."""
