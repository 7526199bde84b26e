"""Device meshes: one card's host mesh and the reference's pod shapes.

Port of ``repro.launch.mesh``.  ``make_host_mesh`` is a 1 x 1
``('data', 'model')`` ``DeviceMesh`` on the card (or on the CPU when asked,
as the tests do).  A mesh needs a default process group; where the process
has none, a group of one rank is started over an in-process ``HashStore``
(NCCL on the card, gloo on the CPU), so no environment variable is needed.
The group is process-global: ``destroy_host_mesh`` ends it again, when
this module started it, and ``host_mesh`` is the mesh for a ``with``
block that ends the group after it only if the block started it.

``make_production_mesh`` builds the reference's pod shapes, (16, 16)
``('data', 'model')`` and, multi-pod, (2, 16, 16) ``('pod', 'data',
'model')``, and ``make_mesh`` a mesh of any shape, over the ranks of an
initialized process group (gloo processes on the CPU, NCCL on the
cards); both raise when the group's size is not the mesh's, as the
reference raises when there are fewer devices.  ``fake_mesh`` is such a
mesh over the fake process group of ``torch.testing``, whose
collectives move nothing: the dry run's pods.  ``production_mesh_shape``
is the same shape as a ``MeshShape`` (names and sizes, no devices),
which is all that resolving placements reads.
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterator

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device
from repro_torch.sharding.rules import MeshShape

_STARTED = False          # whether make_host_mesh started the process group


def production_mesh_shape(*, multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_mesh(shape: MeshShape, device_type: str = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape``'s names and sizes over the ranks of
    the initialized process group (whose size must be the mesh's)."""
    n = math.prod(shape.shape)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != n:
        raise RuntimeError(
            f"mesh {shape.shape} needs {n} ranks, have {have}: start a "
            f"process group of {n} ranks first")
    return init_device_mesh(device_type, tuple(shape.shape),
                            mesh_dim_names=tuple(shape.axis_names))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    return make_mesh(production_mesh_shape(multi_pod=multi_pod),
                     device_type)


@contextlib.contextmanager
def fake_mesh(shape: MeshShape) -> Iterator[DeviceMesh]:
    """A mesh of ``shape`` over the fake process group of
    ``torch.testing`` (this process is its rank 0; a collective moves
    nothing), for a ``with`` block: the dry run places a model on the
    pod meshes and counts its step on ``meta`` so.  There must be no
    process group yet; the fake one ends after the block."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_mesh: a process group is already running")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=shape.size())
    try:
        yield make_mesh(shape, "cpu")
    finally:
        dist.destroy_process_group()


def make_host_mesh(device=None) -> DeviceMesh:
    """1 x 1 ``('data', 'model')`` mesh on the card (``device=None``) or on
    ``device``; starts a process group of one rank if there is none."""
    global _STARTED
    dev = resolve_device(device)
    if not dist.is_initialized():
        backend = "gloo" if dev.type == "cpu" else "cpu:gloo,cuda:nccl"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
        _STARTED = True
    return init_device_mesh(dev.type, (1, 1),
                            mesh_dim_names=("data", "model"))


def destroy_host_mesh() -> None:
    """End the process group if ``make_host_mesh`` started it."""
    global _STARTED
    if _STARTED and dist.is_initialized():
        dist.destroy_process_group()
    _STARTED = False


@contextlib.contextmanager
def host_mesh(device=None) -> Iterator[DeviceMesh]:
    """``make_host_mesh`` for a ``with`` block; the process group ends
    after it if the block started it."""
    owns = not dist.is_initialized()
    try:
        yield make_host_mesh(device)
    finally:
        if owns:
            destroy_host_mesh()
