"""Entry points: the steps (``steps.py``), the trainer (``train.py``), the
meshes (``mesh.py``), the dry run's abstract inputs (``specs.py``) and the
dry run (``dryrun.py``)."""
