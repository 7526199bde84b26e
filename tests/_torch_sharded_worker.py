"""One gloo rank of ``test_torch_sharded_step.py``'s (2, 2) mesh.

``python _torch_sharded_worker.py RANK STORE INPUTS.npz OUT.npz`` (four
processes, one a rank, meeting in the ``FileStore`` at STORE).  For each
case of ``_torch_sharded_cases``: the reference's weights through
``bridge.from_jax_params``, placed with ``sharding.rules.place_params``;
the prefill and serve steps of ``launch.steps`` on the placed batch and
cache, then ``STEPS`` train steps with ``muon_sharded_ns``; for GLM-5's
first MoE layer its expert-parallel output and the drops each rank's
dispatch counts.  Rank 0 writes the whole tensors (``full_tensor``) the
test compares with the reference's.
"""
import sys
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

import _torch_sharded_cases as C
from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import TrainConfig
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.specs import place_cache
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.layers import moe as tmoe
from repro_torch.models import get_model
from repro_torch.optim import muon
from repro_torch.sharding.rules import (MeshShape, make_rules, place_batch,
                                        place_params)


def _whole(x) -> np.ndarray:
    """A copy of the whole tensor (a replicated ``DTensor``'s
    ``full_tensor`` is its local tensor, which the next step updates)."""
    if hasattr(x, "full_tensor"):
        x = x.full_tensor()
    return x.detach().numpy().copy()


def _fill(tree, arrays, prefix):
    for k, v in tree.items():
        if isinstance(v, dict):
            _fill(v, arrays, f"{prefix}/{k}")
        else:
            v.copy_(torch.from_numpy(arrays[f"{prefix}/{k}"]))


def _run_case(name, data, mesh, rules, res):
    cfg = get_smoke_config(name).replace(**C.OVERRIDES[name])
    M = get_model(cfg)
    model = from_jax_params(C.unflatten(data, f"{name}/params"), cfg,
                            device="cpu")
    place_params(model, mesh, rules)

    tokens = torch.from_numpy(data[f"{name}/prefill/tokens"])
    res[f"{name}/prefill"] = _whole(make_prefill_step(model, mesh=mesh)(
        place_batch({"tokens": tokens}, mesh, rules)))
    cache = M.init_cache(cfg, C.BATCH, C.CACHE_LEN, device="cpu")
    _fill(cache, data, f"{name}/cache")
    cache = place_cache(cfg, cache, mesh, rules)
    token = place_batch({"t": torch.from_numpy(
        data[f"{name}/serve/token"])}, mesh, rules)["t"]
    logits, _ = make_serve_step(model, mesh=mesh)(token, cache,
                                                  C.CACHE_INDEX)
    res[f"{name}/serve"] = _whole(logits)

    if name == "glm5_744b":
        _ep_layer(model, cfg, data, mesh, rules, res)

    # the clipped gradients the step hands Muon, as the reference returns
    grads, clip = [], muon.global_norm_clip

    def recording_clip(g, max_norm):
        g, norm = clip(g, max_norm)
        grads.append({k: _whole(v) for k, v in g.items()})
        return g, norm
    muon.global_norm_clip = recording_clip
    params = dict(model.named_parameters())
    state = muon.init(params, M.param_axes(model))
    step = make_train_step(model, mesh=mesh, train_cfg=TrainConfig(),
                           lr=C.LR, muon_sharded_ns=True)
    for i in range(C.STEPS):
        batch = place_batch({k: torch.from_numpy(data[f"{name}/batch{i}/{k}"])
                             for k in ("tokens", "targets", "loss_mask")},
                            mesh, rules)
        state, metrics = step(state, batch)
        res[f"{name}/loss{i}"] = _whole(metrics["loss"])
        for n, p in params.items():
            res[f"{name}/params{i}/{n}"] = _whole(p)
            res[f"{name}/grads{i}/{n}"] = grads[-1][n]
    muon.global_norm_clip = clip
    if cfg.dsa is not None and cfg.family != "hybrid":
        _warmup_step(model, M, data, name, mesh, rules, res)


def _warmup_step(model, M, data, name, mesh, rules, res):
    """One step of the indexer warm-up (``freeze="all_but_indexer"``) on
    the placed model: the largest move of a frozen leaf and the smallest
    move of an indexer leaf."""
    before = {n: _whole(p) for n, p in model.named_parameters()}
    step = make_train_step(model, mesh=mesh, lr=C.LR, muon_sharded_ns=True,
                           freeze="all_but_indexer")
    state = muon.init(dict(model.named_parameters()), M.param_axes(model))
    step(state, place_batch({k: torch.from_numpy(
        data[f"{name}/batch0/{k}"]) for k in ("tokens", "targets",
                                             "loss_mask")}, mesh, rules))
    moved = {n: np.abs(_whole(p) - before[n]).max()
             for n, p in model.named_parameters()}
    idx = [n for n in moved if "idx" in n.split(".")]
    res[f"{name}/warmup/frozen_max"] = np.float32(max(
        v for n, v in moved.items() if n not in idx))
    res[f"{name}/warmup/indexer_min"] = np.float32(min(moved[n]
                                                       for n in idx))


def _ep_layer(model, cfg, data, mesh, rules, res):
    layer = model.layers[C.EP_LAYER].moe
    x = torch.from_numpy(data["ep/x"])
    y, aux = tmoe.apply_moe(layer, place_batch({"x": x}, mesh, rules)["x"],
                            cfg, mesh=mesh)
    res["ep/y"], res["ep/aux"] = _whole(y), _whole(aux)
    # the dense path on placed tensors (``_placed_dense``)
    y, aux = tmoe.apply_moe(layer, place_batch({"x": x}, mesh, rules)["x"],
                            cfg.replace(moe_impl="dense"), mesh=mesh)
    res["dense/y"], res["dense/aux"] = _whole(y), _whole(aux)
    # this rank's drops: its 'data' shard's tokens, its 'model' experts
    d, r = mesh.get_coordinate()
    x2d = x.reshape(-1, x.shape[-1])
    T = x2d.shape[0] // C.MESH_SHAPE[0]
    E_local = cfg.num_experts // C.MESH_SHAPE[1]
    local = {k: getattr(layer, k).full_tensor()
             for k in ("router", "w_gate", "w_up", "w_down")}
    gates, idx, _ = tmoe.router_topk(SimpleNamespace(**local),
                                     x2d[d * T:(d + 1) * T], cfg)
    cap = max(1, int(np.ceil(T * cfg.experts_per_token / cfg.num_experts
                             * cfg.capacity_factor)))
    tok, _, _ = tmoe._dispatch_local(idx, gates, T, r * E_local, E_local,
                                     cap)
    mine = ((idx >= r * E_local) & (idx < (r + 1) * E_local)).sum()
    drops = torch.stack([mine - (tok < T).sum()]).float()
    dist.all_reduce(drops)
    res["ep/drops"] = drops.numpy()[0]


def main(rank: int, store: str, inputs: str, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, C.WORLD),
                            rank=rank, world_size=C.WORLD)
    try:
        mesh = make_mesh(MeshShape(C.MESH_NAMES, C.MESH_SHAPE), "cpu")
        rules = make_rules(mesh)
        data = np.load(inputs)
        res: dict = {}
        for name in C.CASES:
            _run_case(name, data, mesh, rules, res)
        if rank == 0:
            np.savez(out, **res)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4])
