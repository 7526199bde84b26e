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
``torch.distributed.device_mesh.DeviceMesh``.

``place_params`` is the reference's ``jax.device_put(params,
tree_shardings(...))``: every parameter of a model becomes a ``DTensor``
with its placements, in place.  ``place_tree`` does the same for a batch
(``place_batch``: the leading dimension over ('pod', 'data')) and a
decode cache (its logical axes, ``launch.specs.cache_axes``).  Each rank
keeps its own slice of the whole tensor it is given, so nothing is sent;
a ``meta`` tensor becomes a ``meta`` local shard of the placed shape,
which is how the dry run places a model of 744 B parameters on 512
ranks of a fake process group.

The constraints (``constrain``, ``constrain_batch``,
``constrain_batch_seq``) redistribute a ``DTensor`` on a mesh of more
than one rank and are identities elsewhere.  ``local_apply`` is where a
placed activation meets a function that must see plain tensors — a
hand-written kernel's wrapper, which takes raw pointers and refuses a
``DTensor``: it redistributes each input to the placements the caller
names (its shard of the batch, of the heads, of the channels), runs the
function on the local tensors and wraps its outputs again; the backward
takes each input's local gradient with the placements the caller names
for it (``Partial`` where each rank holds a part of a sum).

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

import contextlib
import math
from typing import (Any, Callable, Dict, NamedTuple, Optional, Sequence,
                    Tuple)

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

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


# ---------------------------------------------------------------------------
# placing trees, and local shards for the kernels
# ---------------------------------------------------------------------------

def _local_slice(x: torch.Tensor, placements: Sequence[Any],
                 mesh) -> torch.Tensor:
    """This rank's slice of the whole tensor ``x`` (its coordinate on each
    mesh dimension picks the chunk, mesh dimensions in order, as DTensor
    nests two that shard one dimension)."""
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.size(i)
            x = x.narrow(p.dim, coord[i] * (x.shape[p.dim] // n),
                         x.shape[p.dim] // n)
    return x


def place(x: torch.Tensor, placements: Sequence[Any], mesh) -> DTensor:
    """The whole tensor ``x`` (the same on every rank) as a ``DTensor``
    over ``mesh``: each rank keeps its slice, no collective.  A ``meta``
    tensor becomes a ``meta`` shard of the placed shape.  A mesh dimension
    of one rank replicates (the same tensor: DTensor's views refuse to
    fold a batch of one sharded over it)."""
    placements = tuple(Replicate() if mesh.size(i) == 1 else p
                       for i, p in enumerate(placements))
    if x.is_meta:
        local = torch.empty(local_shape(x.shape, placements, mesh),
                            dtype=x.dtype, device="meta")
    else:
        local = _local_slice(x.detach(), placements, mesh).contiguous()
    return DTensor.from_local(local, mesh, placements, shape=x.shape,
                              stride=torch.empty(x.shape,
                                                 device="meta").stride())


def place_tree(tree: Any, shardings: Any) -> Any:
    """Nested dicts of whole tensors beside their ``Sharding``s (same
    keys) -> the same dicts of ``DTensor``s."""
    if isinstance(tree, dict):
        return {k: place_tree(v, shardings[k]) for k, v in tree.items()}
    return place(tree, shardings.placements, shardings.mesh)


def place_params(model: nn.Module, mesh, rules: Dict[str, Any],
                 axes: Optional[Dict[str, Any]] = None) -> nn.Module:
    """Every parameter of ``model`` as a ``DTensor`` with ``tree_shardings``'
    placements (``axes``: the model's ``param_axes``, by default its
    family's), in place; returns the model."""
    if axes is None:
        from repro_torch.models import get_model
        axes = get_model(model.cfg).param_axes(model)
    shardings = tree_shardings(model, axes, rules, mesh)
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        module = model.get_submodule(owner) if owner else model
        placed = place(p.data, shardings[name].placements, mesh)
        setattr(module, leaf, nn.Parameter(placed,
                                           requires_grad=p.requires_grad))
    return model


def place_batch(batch: Dict[str, torch.Tensor], mesh,
                rules: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A batch's tensors with their leading dimension on the 'batch'
    rule's axes (where it divides), the rest replicated."""
    return {k: place(v, resolve_spec(("batch",) + (None,) * (v.ndim - 1),
                                     v.shape, rules, mesh), mesh)
            for k, v in batch.items()}


def is_placed(*xs) -> bool:
    return any(isinstance(x, DTensor) for x in xs)


def placed_region(model: nn.Module):
    """The context a step of a placed model runs in: plain tensors that
    meet its ``DTensor``s (RoPE's tables, masks, positions, a zero initial
    state, each made at the whole batch's shape) are taken as replicated,
    as the reference's ``jit`` takes its constants.  A no-op for a model
    of plain tensors."""
    if any(isinstance(p, DTensor) for p in model.parameters()):
        return implicit_replication()
    return contextlib.nullcontext()


def batch_placements(mesh, batch: int, *, model_dim: Optional[int] = None,
                     size: Optional[int] = None) -> Tuple[Any, ...]:
    """A local region's placements of an activation: dimension 0 over the
    batch axes ('pod', 'data') where ``batch`` divides over them, and
    dimension ``model_dim`` over 'model' where ``size`` divides over it;
    every other mesh dimension replicated."""
    names = mesh_axes(mesh)
    axes = _batch_axes(mesh)
    out = []
    for a, n in names.items():
        if n > 1 and a in axes and batch % _mesh_axis_size(mesh, axes) == 0:
            out.append(Shard(0))
        elif n > 1 and a == "model" and model_dim is not None \
                and size % n == 0:
            out.append(Shard(model_dim))
        else:
            out.append(Replicate())
    return tuple(out)


def batch_shard_index(mesh, axes: Sequence[str]) -> int:
    """This rank's shard of a dimension sharded over the mesh ``axes`` (in
    mesh order, the outer first: DTensor's nesting)."""
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    index = 0
    for a in axes:
        index = index * mesh_axes(mesh)[a] + coord[a]
    return index


def split_dim(x: torch.Tensor, dim: int, sizes: Sequence[int]
              ) -> torch.Tensor:
    """``x`` with dimension ``dim`` split into ``sizes`` (heads and head
    width).  A placed ``x`` sharded on ``dim`` over a mesh axis that does
    not divide ``sizes[0]`` (Yi-6B's 4 key/value heads on a 16-way
    'model' axis: the rules shard the 512 columns, a quarter of a head a
    rank) is gathered over that axis first, which the reference's XLA
    does implicitly."""
    dim = dim % x.ndim
    if is_placed(x):
        pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == dim
                   and sizes[0] % x.device_mesh.size(i) else p
                   for i, p in enumerate(x.placements))
        if pl != tuple(x.placements):
            x = x.redistribute(x.device_mesh, pl)
    return x.reshape(*x.shape[:dim], *sizes, *x.shape[dim + 1:])


def replicated(mesh) -> Tuple[Any, ...]:
    return tuple(Replicate() for _ in mesh_axes(mesh))


def partial_over(placements: Sequence[Any], mesh,
                 axes: Sequence[str]) -> Tuple[Any, ...]:
    """``placements`` with the mesh dimensions named in ``axes`` made
    ``Partial()`` (a gradient each rank holds a part of)."""
    return tuple(Partial() if a in axes else p
                 for a, p in zip(mesh_axes(mesh), placements))


def local_apply(fn: Callable, args: Sequence[Any], placements: Sequence[Any],
                out_placements: Any, *, grad_placements: Sequence[Any] = None,
                mesh=None) -> Any:
    """``fn`` on the local shards of ``args``.

    Each ``DTensor`` argument is redistributed to its entry of
    ``placements`` (None: an argument that is not a tensor, passed as it
    is) and handed to ``fn`` as its local tensor; the backward reads that
    local tensor's gradient with its entry of ``grad_placements`` (by
    default its placements).  ``fn``'s tensor outputs are wrapped with
    ``out_placements`` (one placements tuple, or a tuple of them for a
    tuple of outputs, None for an output that is not a tensor).  Without
    a ``DTensor`` argument it is ``fn(*args)``."""
    if not is_placed(*args):
        return fn(*args)
    if mesh is None:
        mesh = next(a for a in args if isinstance(a, DTensor)).device_mesh
    grad_placements = grad_placements or placements
    local = []
    for a, p, g in zip(args, placements, grad_placements):
        if p is None:
            local.append(a)
            continue
        if not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh, replicated(mesh),
                                   run_check=False)
        a = a.redistribute(mesh, tuple(p))
        local.append(a.to_local(grad_placements=tuple(g)))
    out = fn(*local)
    single = not isinstance(out, tuple)
    outs = (out,) if single else out
    pls = (out_placements,) if single else out_placements
    wrapped = tuple(
        o if p is None else DTensor.from_local(o, mesh, tuple(p),
                                               run_check=False)
        for o, p in zip(outs, pls))
    return wrapped[0] if single else wrapped
