"""PyTorch port: the logical-axis sharding rules and the meshes.

* ``resolve_spec`` equals the reference's for every parameter of every
  one of the eleven FULL configs: the reference's ``PartitionSpec`` (from
  its abstract init's logical axes, resolved on a stub mesh of names and
  shape) as placements, with its leading ``layers`` axis dropped for a
  stacked leaf, against the port's placements for the same weight (by the
  bridge's names), on the host mesh (1, 1), the pod (16, 16) and the
  multi-pod (2, 16, 16), FSDP on and off, and with ``context_parallel_kv``;
* ``make_rules`` equals the reference's on those meshes;
* ``tree_shardings`` over a module, ``local_shape``, and the constraints:
  identities off a mesh, on a plain tensor and on a DTensor over the
  host mesh;
* ``make_host_mesh``: a 1 x 1 ('data', 'model') mesh over a gloo group of
  one rank, started once and ended by ``destroy_host_mesh``;
  ``make_production_mesh`` refuses a process with fewer ranks;
* the step factories, Muon and ``apply_moe`` refuse a mesh of more than
  one rank (``NotImplementedError``).

The process group is ended after the file.
"""
import types

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro import configs as jconfigs
from repro.models import get_model as jax_get_model
from repro.sharding import rules as jrules
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.models import get_model
from repro_torch.sharding import rules as trules
from _torch_threads import one_torch_thread  # noqa: F401

MESHES = {"host": (("data", "model"), (1, 1)),
          "pod": (("data", "model"), (16, 16)),
          "multi_pod": (("pod", "data", "model"), (2, 16, 16))}


@pytest.fixture(scope="module", autouse=True)
def _end_process_group():
    yield
    tmesh.destroy_host_mesh()
    assert not dist.is_initialized()


def _stub(names, shape):
    """The reference's mesh as its ``resolve_spec`` reads it."""
    return types.SimpleNamespace(axis_names=names,
                                 devices=np.empty(shape, dtype=np.int8))


def _ref_node(tree, cfg, name):
    """The reference leaf of the port's parameter ``name`` (the bridge's
    naming) and whether it is stacked on a leading ``layers`` axis."""
    parts = name.split(".")
    stacked = False
    if parts[0] in ("encoder", "decoder"):
        node, rest, stacked = tree[parts[0]], parts[2:], True
    elif parts[0] != "layers":
        node, rest = tree, parts
    else:
        i, rest = int(parts[1]), parts[2:]
        if cfg.family in ("ssm", "hybrid", "audio"):
            node, stacked = tree["layers"], True
        elif i < cfg.first_k_dense:
            node = tree[f"dense_{i}"]
        else:
            j = (i - cfg.first_k_dense) % len(cfg.attention_pattern)
            node, stacked = tree[f"slot{j}"], True
    for p in rest:
        node = node[p]
    return node, stacked


def _as_placements(spec, names, stacked):
    """A reference ``PartitionSpec`` as one placement a mesh dimension,
    the ``layers`` dimension dropped."""
    owner = {}
    for d, axis in enumerate(spec):
        for a in (axis if isinstance(axis, tuple) else (axis,)):
            if a is not None:
                assert not (stacked and d == 0), "the layers axis sharded"
                owner[a] = d - stacked
    return tuple(Shard(owner[a]) if a in owner else Replicate()
                 for a in names)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_resolve_spec_matches_reference_full_configs(arch):
    jcfg = jconfigs.get_config(arch)
    jparams, jspecs = jax_get_model(jcfg).init(jax.random.key(0), jcfg,
                                               abstract=True)
    cfg = get_config(arch)
    M = get_model(cfg)
    model = M.init(cfg, device="meta")
    axes = M.param_axes(model)
    params = dict(model.named_parameters())
    checked = 0
    for names, shape in MESHES.values():
        stub, port_mesh = _stub(names, shape), trules.MeshShape(names, shape)
        for fsdp in (True, False):
            for cp in (False, True):
                want_rules = jrules.make_rules(stub, fsdp=fsdp,
                                               context_parallel_kv=cp)
                rules = trules.make_rules(port_mesh, fsdp=fsdp,
                                          context_parallel_kv=cp)
                assert rules == want_rules
                for name, p in params.items():
                    leaf, stacked = _ref_node(jparams, jcfg, name)
                    ref_axes, _ = _ref_node(jspecs, jcfg, name)
                    assert tuple(leaf.shape)[stacked:] == tuple(p.shape)
                    assert tuple(ref_axes)[stacked:] == tuple(axes[name])
                    want = _as_placements(
                        jrules.resolve_spec(ref_axes, leaf.shape, want_rules,
                                            stub), names, stacked)
                    got = trules.resolve_spec(axes[name], p.shape, rules,
                                              port_mesh)
                    assert got == want, (arch, names, fsdp, cp, name)
                    checked += 1
    assert checked == len(params) * len(MESHES) * 4


def test_tree_shardings_and_local_shapes():
    cfg = get_config("qwen3_moe_235b")
    M = get_model(cfg)
    model = M.init(cfg, device="meta")
    mesh = trules.MeshShape(("data", "model"), (16, 16))
    sh = trules.tree_shardings(model, M.param_axes(model),
                               trules.make_rules(mesh), mesh)
    assert set(sh) == {k for k, _ in model.named_parameters()}
    w_up = sh["layers.0.moe.w_up"]        # (E, D, F): experts x embed_fsdp
    assert w_up.mesh is mesh
    assert w_up.placements == (Shard(1), Shard(0))
    E, D, F = model.layers[0].moe.w_up.shape
    assert trules.local_shape((E, D, F), w_up.placements, mesh) == \
        (E // 16, D // 16, F)
    # a nested tree (a cache) beside its axes
    cache = {"slot0": {"k": torch.empty(2, 32, 64, 4, 8, device="meta")}}
    axes = {"slot0": {"k": ("layers", "batch", "kv_seq", "kv_heads",
                            "head_dim")}}
    got = trules.tree_shardings(cache, axes, trules.make_rules(mesh), mesh)
    assert got["slot0"]["k"].placements == (Shard(1), Replicate())


def test_host_mesh_constraints_are_identities():
    assert not dist.is_initialized()
    mesh = tmesh.make_host_mesh("cpu")
    assert dist.is_initialized() and dist.get_world_size() == 1
    assert mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.shape) == (1, 1)
    again = tmesh.make_host_mesh("cpu")          # reuses the group
    assert again.mesh_dim_names == mesh.mesh_dim_names
    rules = trules.make_rules(mesh)
    x = torch.randn(4, 8, 16)
    for m in (None, mesh):
        assert trules.constrain(x, ("batch", "seq", "embed"), rules, m) is x
        assert trules.constrain_batch(x, m) is x
        assert trules.constrain_batch_seq(x, m) is x
    d = distribute_tensor(x, mesh, (Replicate(), Replicate()))
    assert trules.constrain_batch(d, mesh) is d
    assert trules.constrain(d, ("batch", None, None), rules, mesh) is d
    with pytest.raises(RuntimeError):
        tmesh.make_production_mesh(device_type="cpu")
    tmesh.destroy_host_mesh()
    assert not dist.is_initialized()


def test_meshes_of_more_than_one_rank_are_refused():
    from repro_torch.layers import moe
    from repro_torch.optim import muon
    cfg = get_smoke_config("qwen3_moe_235b")
    model = get_model(cfg).init(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    pod = tmesh.production_mesh_shape()
    assert pod.size() == 256
    for factory in (make_train_step, make_prefill_step, make_serve_step):
        with pytest.raises(NotImplementedError):
            factory(model, mesh=pod)
    blk = model.layers[0].moe
    with pytest.raises(NotImplementedError):
        moe.apply_moe(blk, torch.zeros(1, 4, cfg.d_model), cfg, mesh=pod)
    with pytest.raises(NotImplementedError):
        muon._ns_group_constraint(torch.zeros(4, 8, 8), pod)


@pytest.mark.parametrize("arch", ["yi_6b", "falcon_mamba_7b", "zamba2_2p7b",
                                  "whisper_base"])
def test_steps_pass_the_host_mesh_to_every_family(arch):
    """Every family's entry points take the mesh of one rank from the step
    factories; the logits equal the steps' without a mesh, bitwise."""
    cfg = get_smoke_config(arch)
    M = get_model(cfg)
    model = M.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    mesh = tmesh.make_host_mesh("cpu")
    rng = np.random.default_rng(0)
    B, S = 2, 8
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))}
    if cfg.family == "audio":
        batch["frontend_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32))
    want = make_prefill_step(model)(batch)
    got = make_prefill_step(model, mesh=mesh)(batch)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    outs = []
    for m in (None, mesh):
        cache = M.init_cache(cfg, B, 4, device="cpu")
        logits, _ = make_serve_step(model, mesh=m)(batch["tokens"][:, :1],
                                                   cache, 0)
        outs.append(logits)
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=0)
