"""PyTorch port: the expert-parallel MoE path against the JAX package.

* ``_dispatch_local``: the gather indices and slot gates equal the
  reference's exactly, over seeded assignments with every expert chosen by
  many tokens (ties in the slot order) at capacities that drop most, some
  and none of them, for all experts and for a rank's slice of them;
* ``apply_moe`` with ``moe_impl="expert_parallel"`` on qwen3-moe's and
  kimi-k2's smoke configs (the latter with its shared expert), off a mesh
  and on the 1 x 1 gloo host mesh, equal to the reference's EP path under
  ``jax.jit`` on its host mesh at the default ``capacity_factor`` 1.25 and
  at 0.5 (drops included, at least one at 0.5) within 3e-5 and ``aux`` at
  1e-5 (the bounds of ``tests/test_substrate.py``'s EP test), and at
  ``capacity_factor=8`` equal to ``_moe_dense`` and to the reference's
  dense oracle; two EP runs bitwise equal;
* the EP path runs on ``meta`` tensors (it reads nothing back to the
  host), where the routed path cannot.

One JAX oracle for the file; the process group is ended after it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import configs as jconfigs
from repro.launch.mesh import make_host_mesh as jax_host_mesh
from repro.layers import moe as jmoe
from repro.sharding.rules import Builder
from repro_torch.configs import get_smoke_config
from repro_torch.launch import mesh as tmesh
from repro_torch.layers import moe as tmoe
from _torch_threads import one_torch_thread  # noqa: F401

ARCHS = ("qwen3_moe_235b", "kimi_k2_1t")
DROPPING = (1.25, 0.5)
AMPLE = 8.0
ATOL = RTOL = 3e-5


@pytest.fixture(scope="module", autouse=True)
def _end_process_group():
    yield
    tmesh.destroy_host_mesh()
    assert not dist.is_initialized()


@pytest.fixture(scope="module")
def oracle():
    """Per arch: the port's MoE module, the input, and the reference's
    outputs: EP at each capacity factor, and the dense oracle."""
    jmesh = jax_host_mesh()
    out = {}
    for n, arch in enumerate(ARCHS):
        jcfg = jconfigs.get_smoke_config(arch)
        b = Builder(jax.random.key(n), jnp.float32)
        jmoe.build_moe(b, jcfg)
        cfg = get_smoke_config(arch)
        module = tmoe.MoE(cfg, device="cpu", dtype=torch.float32)
        module.load_state_dict({k: torch.tensor(np.asarray(v))
                                for k, v in b.params.items()}, strict=True)
        x = (np.random.default_rng(n).standard_normal(
            (2, 32, cfg.d_model)) * 0.1).astype(np.float32)
        ref = {}
        for cf in DROPPING + (AMPLE,):
            c = jcfg.replace(moe_impl="expert_parallel", capacity_factor=cf)
            with jmesh:
                y, aux = jax.jit(lambda p, xx, c=c: jmoe.apply_moe(
                    p, xx, c, mesh=jmesh))(b.params, jnp.asarray(x))
            ref[cf] = (np.asarray(y), float(aux))
        y, aux = jmoe.apply_moe(b.params, jnp.asarray(x),
                                jcfg.replace(moe_impl="dense"), mesh=None)
        ref["dense"] = (np.asarray(y), float(aux))
        out[arch] = (cfg, module, x, ref)
    return out


def _assignments(rng, T, k, E):
    idx = np.stack([rng.permutation(E)[:k] for _ in range(T)])
    gates = rng.random((T, k)).astype(np.float32)
    return idx, gates / gates.sum(1, keepdims=True)


@pytest.mark.parametrize("capacity", [1, 3, 7, 100])
@pytest.mark.parametrize("e_lo,E_local", [(0, 6), (2, 3)])
def test_dispatch_local_matches_reference(capacity, e_lo, E_local):
    T, k, E = 50, 3, 6
    idx, gates = _assignments(np.random.default_rng(capacity), T, k, E)
    want_tok, want_gate = jmoe._dispatch_local(
        jnp.asarray(idx), jnp.asarray(gates), T, jnp.asarray(e_lo), E_local,
        capacity)
    tok, gate, dest = tmoe._dispatch_local(
        torch.from_numpy(idx), torch.from_numpy(gates), T, e_lo, E_local,
        capacity)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(want_tok))
    np.testing.assert_array_equal(gate.numpy(), np.asarray(want_gate))
    # the inverse map: each placed assignment's slot holds its token
    flat_tok = np.repeat(np.arange(T), k)
    placed = dest.numpy() < E_local * capacity
    np.testing.assert_array_equal(tok.numpy().reshape(-1)[dest[placed]],
                                  flat_tok[placed])
    local = ((idx >= e_lo) & (idx < e_lo + E_local)).sum()
    assert placed.sum() == min(local, (tok.numpy() < T).sum())
    if capacity == 1:
        assert placed.sum() < local          # drops happened


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("on_mesh", [False, True])
def test_ep_matches_reference_ep_and_dense(oracle, arch, on_mesh):
    cfg, module, x, ref = oracle[arch]
    mesh = tmesh.make_host_mesh("cpu") if on_mesh else None
    xt = torch.from_numpy(x)
    for cf in DROPPING + (AMPLE,):
        c = cfg.replace(moe_impl="expert_parallel", capacity_factor=cf)
        y, aux = tmoe.apply_moe(module, xt, c, mesh=mesh)
        y2, _ = tmoe.apply_moe(module, xt, c, mesh=mesh)
        assert torch.equal(y, y2)                      # deterministic
        want_y, want_aux = ref[cf]
        np.testing.assert_allclose(y.numpy(), want_y, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(float(aux), want_aux, rtol=1e-5)
    # at ample capacity: the dense oracles (the reference's, whole; the
    # port's, the experts' part alone)
    np.testing.assert_allclose(y.numpy(), ref["dense"][0], atol=ATOL,
                               rtol=RTOL)
    x2d = xt.reshape(-1, cfg.d_model)
    y_ep, aux_ep = tmoe._moe_ep(module, x2d, cfg.replace(
        moe_impl="expert_parallel", capacity_factor=AMPLE), mesh)
    y_dense, aux_dense = tmoe._moe_dense(module, x2d, cfg)
    np.testing.assert_allclose(y_ep.numpy(), y_dense.numpy(), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(float(aux_ep), float(aux_dense), rtol=1e-5)


def test_default_capacity_drops_at_half(oracle):
    """At capacity_factor 0.5 the smoke inputs drop assignments, so the
    comparison above covers drops."""
    cfg, module, x, _ = oracle["qwen3_moe_235b"]
    x2d = torch.from_numpy(x).reshape(-1, cfg.d_model)
    T = x2d.shape[0]
    gates, idx, _ = tmoe.router_topk(module, x2d, cfg)
    cap = max(1, int(np.ceil(T * cfg.experts_per_token / cfg.num_experts
                             * 0.5)))
    tok, _, _ = tmoe._dispatch_local(idx, gates, T, 0, cfg.num_experts, cap)
    assert (tok < T).sum() < T * cfg.experts_per_token


def test_ep_runs_on_meta_and_routed_does_not():
    cfg = get_smoke_config("kimi_k2_1t")
    module = tmoe.MoE(cfg, device="meta")
    x = torch.empty(2, 16, cfg.d_model, device="meta")
    y, aux = tmoe.apply_moe(module, x, cfg.replace(
        moe_impl="expert_parallel"))
    assert y.shape == x.shape and y.device.type == "meta"
    with pytest.raises((NotImplementedError, RuntimeError)):
        tmoe.apply_moe(module, x, cfg)
