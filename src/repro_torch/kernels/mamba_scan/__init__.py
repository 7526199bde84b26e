"""K11 Mamba-1 selective scan: the CUDA wrappers, the autograd Function of
the model's form (``kernel.py``), their plain versions and the plain
gradient (``ref.py``) and the Pallas kernel's entry point (``ops.py``)."""
