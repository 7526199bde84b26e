"""Logical-axis sharding rules (MaxText-style) over device meshes.

Port of ``repro.sharding.rules``.  Every parameter carries a tuple of
*logical axis names*, one a dimension: the ``AXES`` of the module that
owns it, gathered by the model's ``param_axes``.  The names resolve to
mesh dimensions through a rules table, with the reference's guards: mesh
axes the mesh does not have are dropped, a dimension that the mesh axes'
size does not divide is replicated (gemma2's 8 query heads on a 16-way
'model' axis), and a mesh axis shards at most one dimension of a tensor.
FSDP (ZeRO-3, the paper's §2.4.1 sharded gradients and optimizer state)
maps the ``embed_fsdp`` axis onto 'data'.

The reference's ``PartitionSpec`` is here a tuple of placements, one a
mesh dimension: ``Shard(d)`` where the mesh dimension shards tensor
dimension d, else ``Replicate()`` (DTensor's form).  A tensor dimension
sharded over two mesh axes, the reference's ``("pod", "data")``, is
``Shard(d)`` on both, in mesh order as the reference's tuple.

``resolve_spec`` reads only a mesh's dimension names and sizes, so a
``MeshShape`` (names and sizes, no devices) serves as well as a
``torch.distributed.device_mesh.DeviceMesh``: the dry run resolves the
pod meshes' placements without a process group of 256 ranks.

The reference creates parameters through ``Builder`` / ``stack_init`` /
``spec_leaf``, which record each array's logical axes beside it and stack
each pattern slot's layers on a leading ``layers`` axis for
``lax.scan``.  The port's counterpart is its ``nn.Module``s: each module's
``AXES`` names its parameters' axes, ``param_axes`` gathers them by
parameter name, and a model built on the ``meta`` device is the abstract
init.  The port keeps one module a layer, so its axes for a layer's
weight are the reference's without the leading ``layers`` entry (which
the rules map to ``None``: the placements are the same but for that
dimension's index).
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

# logical axis -> mesh axis (or tuple of mesh axes, or None = replicate).
# Mesh axes that do not exist in the current mesh are dropped at resolve time.
DEFAULT_RULES: Dict[str, Any] = {
    "batch": ("pod", "data"),
    "seq": None,
    "kv_seq": None,            # context-sharded over 'data' for long-decode
    "embed": None,
    "embed_fsdp": "data",      # param d_model dim under FSDP
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "experts": "model",
    "moe_mlp": None,
    "layers": None,
    "conv": None,
    "ssm_inner": "model",
    "ssm_state": None,
    "index_heads": None,
    "topk": None,
    "lora": None,
}


class MeshShape(NamedTuple):
    """A mesh's dimension names and sizes, without devices."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]

    def size(self) -> int:
        return math.prod(self.shape)


class Sharding(NamedTuple):
    """A tensor's mesh and placements (the reference's ``NamedSharding``)."""
    mesh: Any
    placements: Tuple[Any, ...]


def mesh_axes(mesh) -> Dict[str, int]:
    """{dimension name: size} of a ``DeviceMesh`` or a ``MeshShape``."""
    if isinstance(mesh, MeshShape):
        return dict(zip(mesh.axis_names, mesh.shape))
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def make_rules(mesh, *, fsdp: bool = True,
               context_parallel_kv: bool = False,
               overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    rules = dict(DEFAULT_RULES)
    if not fsdp:
        rules["embed_fsdp"] = None
    if context_parallel_kv:
        rules["kv_seq"] = "data"
        rules["batch"] = "pod" if "pod" in mesh_axes(mesh) else None
    if overrides:
        rules.update(overrides)
    return rules


def _mesh_axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        return math.prod(_mesh_axis_size(mesh, a) for a in axis)
    return mesh_axes(mesh).get(axis, 1)


def _resolve_axes(logical_axes: Sequence[Optional[str]],
                  shape: Sequence[int], rules: Dict[str, Any], mesh
                  ) -> Tuple[Any, ...]:
    """Logical axes + shape -> the mesh axis (None, a name or a tuple of
    names) of each tensor dimension: the reference's ``PartitionSpec``
    entries, with its guards."""
    names = mesh_axes(mesh)
    used: set = set()
    parts = []
    for dim, name in zip(shape, logical_axes):
        axis = rules.get(name) if name else None
        # drop mesh axes that don't exist in this mesh
        if isinstance(axis, (tuple, list)):
            axis = tuple(a for a in axis if a in names)
            axis = axis if axis else None
            if isinstance(axis, tuple) and len(axis) == 1:
                axis = axis[0]
        elif axis is not None and axis not in names:
            axis = None
        # divisibility + single-use guards
        if axis is not None:
            size = _mesh_axis_size(mesh, axis)
            flat = tuple(axis) if isinstance(axis, tuple) else (axis,)
            if dim % size != 0 or any(a in used for a in flat):
                axis = None
            else:
                used.update(flat)
        parts.append(axis)
    return tuple(parts)


def _placements(parts: Sequence[Any], mesh) -> Tuple[Any, ...]:
    """Per-tensor-dimension mesh axes -> one placement a mesh dimension."""
    owner = {}
    for d, axis in enumerate(parts):
        for a in (axis if isinstance(axis, tuple) else (axis,)):
            if a is not None:
                owner[a] = d
    return tuple(Shard(owner[a]) if a in owner else Replicate()
                 for a in mesh_axes(mesh))


def resolve_spec(logical_axes: Sequence[Optional[str]],
                 shape: Sequence[int], rules: Dict[str, Any],
                 mesh) -> Tuple[Any, ...]:
    """Logical axes + concrete shape -> placements (one a mesh dimension),
    with the divisibility and single-use guards."""
    return _placements(_resolve_axes(logical_axes, shape, rules, mesh), mesh)


def local_shape(shape: Sequence[int], placements: Sequence[Any],
                mesh) -> Tuple[int, ...]:
    """The shape each rank holds of a tensor of ``shape`` so placed (the
    resolved placements divide their dimensions)."""
    out = list(shape)
    for size, p in zip(mesh_axes(mesh).values(), placements):
        if isinstance(p, Shard):
            out[p.dim] //= size
    return tuple(out)


def tree_shardings(params: Any, axes: Any, rules: Dict[str, Any],
                   mesh) -> Any:
    """Map a (tensors, logical axes) pair of trees to ``Sharding``s: a
    module or a dict of tensors by name beside a dict of axes by the same
    names (``param_axes``), or nested dicts of both (a cache)."""
    if isinstance(params, nn.Module):
        params = dict(params.named_parameters())
    if isinstance(params, dict):
        return {k: tree_shardings(v, axes[k], rules, mesh)
                for k, v in params.items()}
    return Sharding(mesh, resolve_spec(axes, params.shape, rules, mesh))


def _on_mesh(x: torch.Tensor, mesh) -> bool:
    """True where a constraint can act: a DTensor over a mesh of more than
    one rank.  Off a mesh, on a mesh of one rank and on plain tensors the
    constraints are identities."""
    return (mesh is not None and isinstance(x, DTensor)
            and math.prod(mesh_axes(mesh).values()) > 1)


def constrain(x: torch.Tensor, logical_axes: Sequence[Optional[str]],
              rules: Optional[Dict[str, Any]], mesh) -> torch.Tensor:
    """Redistribute ``x`` to its logical axes' placements; the identity
    without a mesh or rules, on one rank, and on a plain tensor."""
    if rules is None or not _on_mesh(x, mesh):
        return x
    return x.redistribute(mesh, resolve_spec(logical_axes, x.shape, rules,
                                             mesh))


def _batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh_axes(mesh))


def constrain_batch_seq(x: torch.Tensor, mesh) -> torch.Tensor:
    """Megatron-SP analogue: the residual stream sharded over batch
    ('pod', 'data') and sequence ('model') between blocks; falls back to
    ``constrain_batch`` where the shapes do not divide, as the reference."""
    if not _on_mesh(x, mesh) or x.ndim < 2:
        return x
    axes = _batch_axes(mesh)
    if not axes or "model" not in mesh_axes(mesh):
        return constrain_batch(x, mesh)
    bsz = _mesh_axis_size(mesh, axes)
    msz = _mesh_axis_size(mesh, "model")
    if x.shape[0] % bsz != 0 or x.shape[1] % msz != 0:
        return constrain_batch(x, mesh)
    parts = (axes if len(axes) > 1 else axes[0], "model")
    return x.redistribute(mesh, _placements(parts, mesh))


def constrain_batch(x: torch.Tensor, mesh) -> torch.Tensor:
    """Anchor an activation's leading batch dimension to the ('pod',
    'data') axes; the identity where the batch does not divide, off a
    mesh and on one rank."""
    if not _on_mesh(x, mesh):
        return x
    axes = _batch_axes(mesh)
    if not axes:
        return x
    size = _mesh_axis_size(mesh, axes)
    if x.ndim == 0 or x.shape[0] % size != 0 or x.shape[0] == 0:
        return x
    return x.redistribute(mesh, _placements(
        (axes if len(axes) > 1 else axes[0],), mesh))
