"""Logical-axis sharding rules over device meshes (``rules.py``)."""
from repro_torch.sharding.rules import (DEFAULT_RULES, MeshShape, Sharding,
                                        constrain, constrain_batch,
                                        constrain_batch_seq, local_shape,
                                        make_rules, mesh_axes, resolve_spec,
                                        tree_shardings)

__all__ = ["DEFAULT_RULES", "MeshShape", "Sharding", "constrain",
           "constrain_batch", "constrain_batch_seq", "local_shape",
           "make_rules", "mesh_axes", "resolve_spec", "tree_shardings"]
