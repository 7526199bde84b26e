"""The cases of ``test_torch_sharded_step.py``, read by its three sides:
the reference's sharded steps (``_torch_sharded_reference.py``, JAX on
four host devices), the port's (``_torch_sharded_worker.py``, four gloo
ranks) and the test itself.

Every case runs on a (2, 2) ``('data', 'model')`` mesh: two serve-side
calls on the first weights (the prefill step over ``PREFILL`` tokens, one
serve step against a cache of ``CACHE_LEN`` positions at
``CACHE_INDEX``), then ``STEPS`` train steps (Muon with
``muon_sharded_ns``, lr ``LR``), each on its own batch of ``BATCH`` x
``SEQ`` tokens.  The configs are the smoke configs with ``OVERRIDES``:
GLM-5 takes the expert-parallel MoE at capacity 1.25, so the layers drop
assignments, which depend on the mesh (each 'data' shard's tokens).
Arrays travel between the processes in ``.npz`` files keyed
``<case>/<what>/<name>``.
"""
import numpy as np

MESH_NAMES = ("data", "model")
MESH_SHAPE = (2, 2)
WORLD = 4

LR = 2e-3
STEPS = 2
BATCH, SEQ = 4, 64
PREFILL = 48
CACHE_LEN, CACHE_INDEX = 32, 20
EP_CAPACITY = 1.25
EP_LAYER = 1          # GLM-5 smoke's first MoE layer (first_k_dense 1)
EP_X_SHARED = 2.0     # the EP layer's tokens' shared direction, its weight

OVERRIDES = {
    "yi_6b": {"dsa": None},
    "glm5_744b": {"moe_impl": "expert_parallel",
                  "capacity_factor": EP_CAPACITY},
    "zamba2_2p7b": {},
}
CASES = tuple(OVERRIDES)


def flatten(tree, prefix: str) -> dict:
    """Nested dicts of arrays -> {prefix/path: array}."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def unflatten(arrays, prefix: str) -> dict:
    """The inverse of ``flatten`` for the keys under ``prefix/``."""
    out: dict = {}
    for key in arrays.files if hasattr(arrays, "files") else arrays:
        if not key.startswith(prefix + "/"):
            continue
        node = out
        parts = key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(arrays[key])
    return out


def locate(cfg, name: str):
    """A port parameter's reference leaf: (path in the stacked tree, index
    on its stacked axis or None), the inverse of ``bridge._jax_leaf``."""
    parts = name.split(".")
    if parts[0] in ("encoder", "decoder"):
        return (parts[0],) + tuple(parts[2:]), int(parts[1])
    if parts[0] != "layers":
        return tuple(parts), None
    i, rest = int(parts[1]), tuple(parts[2:])
    if cfg.family in ("ssm", "hybrid", "audio"):
        return ("layers",) + rest, i
    if i < cfg.first_k_dense:
        return (f"dense_{i}",) + rest, None
    g, j = divmod(i - cfg.first_k_dense, len(cfg.attention_pattern))
    return (f"slot{j}",) + rest, g
