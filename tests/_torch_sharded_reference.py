"""The reference's sharded steps for ``test_torch_sharded_step.py``.

Run as a script in a fresh process (JAX fixes its device count at its
first use): ``python _torch_sharded_reference.py INPUTS.npz OUT.npz``
with ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` and
``JAX_PLATFORMS=cpu``.  On a (2, 2) ``('data', 'model')`` mesh of the
four host devices, for each case of ``_torch_sharded_cases``: the
reference's ``make_prefill_step`` and ``make_serve_step`` under
``jax.jit`` with ``in_shardings`` from its rules, as its dry run lowers
them, then ``STEPS`` of its train step (``jax.value_and_grad`` of the
loss, the global-norm clip, Muon with ``muon_sharded_ns``).  The train
step runs on the port's per-layer tree (stacked for the loss inside the
jit): Muon on the reference's stacked tree sends norm scales and SSM
leaves to Newton–Schulz, the quirk the port does not follow.  For
GLM-5's first MoE layer alone it also writes the expert-parallel output
and the number of assignments the capacity dropped, counted shard by
shard with the reference's own dispatch.
"""
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

import _torch_sharded_cases as C  # noqa: E402
from repro.configs import get_smoke_config  # noqa: E402
from repro.configs.base import TrainConfig  # noqa: E402
from repro.launch.mesh import auto_axis_types  # noqa: E402
from repro.launch.steps import make_prefill_step, make_serve_step  # noqa
from repro.layers import moe as jmoe  # noqa: E402
from repro.models import get_model  # noqa: E402
from repro.optim import muon  # noqa: E402
from repro.sharding.rules import (make_rules, resolve_spec,  # noqa: E402
                                  tree_shardings)


def _at(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _stacker(cfg, names, params):
    """flat {port name: array} -> the reference's tree (stacked axes
    rebuilt), and the flat tree's logical axes by name."""
    where = {n: C.locate(cfg, n) for n in names}

    def stack(flat):
        out: dict = {}
        for path in {w[0] for w in where.values()}:
            parts = sorted(((w[1], n) for n, w in where.items()
                            if w[0] == path), key=lambda t: (t[0] is None,
                                                             t[0] or 0))
            value = flat[parts[0][1]] if parts[0][0] is None else \
                jnp.stack([flat[n] for _, n in parts])
            node = out
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = value
        return out
    return stack, where


def _run_case(name, data, mesh, rules, res):
    cfg = get_smoke_config(name).replace(**C.OVERRIDES[name])
    model = get_model(cfg)
    params = jax.tree.map(jnp.asarray, C.unflatten(data, f"{name}/params"))
    _, specs = model.init(jax.random.key(0), cfg, abstract=True)
    p_shard = tree_shardings(params, specs, rules, mesh)
    row = NamedSharding(mesh, P("data", None))

    # prefill and serve on the first weights
    tokens = jnp.asarray(data[f"{name}/prefill/tokens"])
    prefill = jax.jit(make_prefill_step(cfg, mesh=mesh),
                      in_shardings=(p_shard, {"tokens": row}))
    with mesh:
        res[f"{name}/prefill"] = np.asarray(prefill(params,
                                                    {"tokens": tokens}))
    cache, cache_axes = model.init_cache(cfg, C.BATCH, C.CACHE_LEN)
    filled = C.unflatten(data, f"{name}/cache")
    cache = jax.tree_util.tree_map_with_path(
        lambda path, leaf: jnp.asarray(_at(filled, [k.key for k in path]),
                                       leaf.dtype), cache)
    c_shard = tree_shardings(cache, cache_axes, rules, mesh)
    serve = jax.jit(make_serve_step(cfg, mesh=mesh),
                    in_shardings=(p_shard, row, c_shard,
                                  NamedSharding(mesh, P())))
    with mesh:
        logits, _ = serve(params, jnp.asarray(data[f"{name}/serve/token"]),
                          cache, jnp.asarray(C.CACHE_INDEX, jnp.int32))
    res[f"{name}/serve"] = np.asarray(logits)

    # the train steps on the per-layer tree
    names = list(data[f"{name}/names"])
    stack, where = _stacker(cfg, names, params)
    flat = {n: (_at(params, w[0]) if w[1] is None else _at(params, w[0])[w[1]])
            for n, w in where.items()}
    flat_axes = {n: tuple(_at(specs, w[0]))[0 if w[1] is None else 1:]
                 for n, w in where.items()}
    f_shard = {n: NamedSharding(mesh, resolve_spec(flat_axes[n], v.shape,
                                                   rules, mesh))
               for n, v in flat.items()}
    tc = TrainConfig()
    st_shard = muon.MuonState(f_shard, f_shard, NamedSharding(mesh, P()))

    def train_step(p, st, batch):
        def loss_fn(q):
            return model.loss(stack(q), batch, cfg, mesh=mesh)
        (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        grads, _ = muon.global_norm_clip(grads, tc.grad_clip)
        p, st = muon.update(p, grads, flat_axes, st, lr=C.LR, cfg=cfg,
                            weight_decay=tc.weight_decay,
                            split=tc.muon_split, mesh=mesh)
        return p, st, loss, grads

    b_shard = {k: row for k in ("tokens", "targets", "loss_mask")}
    step = jax.jit(train_step, in_shardings=(f_shard, st_shard, b_shard),
                   out_shardings=(f_shard, st_shard, None, None))
    # placed as the step's in_shardings, so its second call reuses the
    # first's compilation
    flat = jax.device_put(flat, f_shard)
    state = jax.device_put(muon.init(flat), st_shard)
    for i in range(C.STEPS):
        batch = {k: jnp.asarray(data[f"{name}/batch{i}/{k}"])
                 for k in ("tokens", "targets", "loss_mask")}
        with mesh:
            flat, state, loss, grads = step(flat, state, batch)
        res[f"{name}/loss{i}"] = np.asarray(loss)
        for n in names:
            res[f"{name}/params{i}/{n}"] = np.asarray(flat[n])
            res[f"{name}/grads{i}/{n}"] = np.asarray(grads[n])
    return cfg, params, specs, where


def _ep_layer(data, mesh, rules, cfg, params, specs, where, res):
    """GLM-5's first MoE layer on the mesh, expert-parallel and dense, and
    the expert-parallel path's drops shard by shard."""
    path, g = where[f"layers.{C.EP_LAYER}.moe.w_up"]
    layer = {k: v[g] for k, v in _at(params, path[:-1]).items()}
    axes = {k: tuple(v)[1:] for k, v in _at(specs, path[:-1]).items()}
    l_shard = {k: NamedSharding(mesh, resolve_spec(axes[k], v.shape, rules,
                                                   mesh))
               for k, v in layer.items()}
    x = jnp.asarray(data["ep/x"])

    def f(p, x):
        return jmoe.apply_moe(p, x, cfg, mesh=mesh)
    with mesh:
        y, aux = jax.jit(f, in_shardings=(
            l_shard, NamedSharding(mesh, P("data", None, None))))(layer, x)
    res["ep/y"], res["ep/aux"] = np.asarray(y), np.asarray(aux)
    # the dense path on the same mesh: the whole batch's aux
    dense = cfg.replace(moe_impl="dense")
    with mesh:
        y, aux = jax.jit(lambda p, x: jmoe.apply_moe(p, x, dense, mesh=mesh),
                         in_shardings=(l_shard, NamedSharding(
                             mesh, P("data", None, None))))(layer, x)
    res["dense/y"], res["dense/aux"] = np.asarray(y), np.asarray(aux)
    x2d = np.asarray(x).reshape(-1, x.shape[-1])
    n_data, n_model = C.MESH_SHAPE
    T = x2d.shape[0] // n_data
    E_local = cfg.num_experts // n_model
    cap = max(1, int(np.ceil(T * cfg.experts_per_token / cfg.num_experts
                             * cfg.capacity_factor)))
    drops = 0
    for d in range(n_data):
        xs = jnp.asarray(x2d[d * T:(d + 1) * T])
        gates, idx, _ = jmoe.router_topk(layer, xs, cfg)
        for r in range(n_model):
            tok, _ = jmoe._dispatch_local(idx, gates, T, r * E_local,
                                          E_local, cap)
            local = ((idx >= r * E_local) & (idx < (r + 1) * E_local)).sum()
            drops += int(local) - int((tok < T).sum())
    res["ep/drops"] = np.asarray(drops)


def main(inputs: str, out: str) -> None:
    data = np.load(inputs)
    mesh = jax.make_mesh(C.MESH_SHAPE, C.MESH_NAMES,
                         devices=jax.devices()[:C.WORLD],
                         **auto_axis_types(2))
    rules = make_rules(mesh)
    res: dict = {}
    for name in C.CASES:
        got = _run_case(name, data, mesh, rules, res)
        if name == "glm5_744b":
            _ep_layer(data, mesh, rules, *got, res)
    np.savez(out, **res)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
