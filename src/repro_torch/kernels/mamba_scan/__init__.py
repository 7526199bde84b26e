"""K11 selective scan (Mamba-1, and Mamba-2's head-shared form): the CUDA
wrappers, the autograd Function of the Mamba-1 model's form
(``kernel.py``), their plain versions and the plain gradient (``ref.py``)
and the Pallas kernel's entry point (``ops.py``)."""
