"""Optimizers: Muon with Muon Split (``muon.py``), LR schedules (``schedule.py``)."""
