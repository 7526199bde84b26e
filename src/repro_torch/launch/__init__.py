"""Training entry points: the step (``steps.py``) and the driver (``train.py``)."""
