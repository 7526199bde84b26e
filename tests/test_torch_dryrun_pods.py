"""PyTorch port: the dry run's sharded step on the pod meshes.

``launch.dryrun.run_one`` on ``pod16x16`` places the model, built on
``meta``, over a fake process group of 256 ranks
(``launch.mesh.fake_mesh``) and counts the real sharded step op by op on
rank 0's shards (``roofline.counting``): a dense and an MoE arch at
``decode_32k``, ``train_4k`` steps (minitron's 24 heads on a 16-way
'model' axis among them) and kimi-k2's ``long_500k`` (the dense MoE
path) carry counted compute, memory and collective terms; the argument
bytes per device equal what the placements decide
(``sharding.rules.local_shape``) within 512 B a tensor; the collective
term divides the wire bytes by the port's own NVLink constant, which the
record names.  The reference's ``context_parallel_kv`` (``long_500k``)
and ``decode_kv_model`` overrides shard the cache as its rules say.  On
a (2, 2) fake mesh the collectives counted for one placed MLP layer
equal a hand count and ``CommDebugMode``'s.  Every hand-written kernel's
wrapper raises on a ``DTensor``.
"""
import json
import math

import numpy as np
import pytest
import torch
from torch.distributed.tensor.debug import CommDebugMode

from repro_torch.configs import canonical, get_config
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.specs import (decode_specs, opt_state_specs,
                                      param_specs, train_batch_specs)
from repro_torch.layers.common import MLP, mlp
from repro_torch.roofline import analysis, counting
from repro_torch.sharding.rules import (MeshShape, constrain_batch,
                                        local_shape, make_rules,
                                        place_batch, place_params)
from _torch_threads import one_torch_thread  # noqa: F401


def _placement_bytes(arch, shape_name, layers, overrides=None):
    """(bytes one rank holds of the step's arguments under the rules,
    their tensor count) on ``pod16x16``, as ``run_one`` configures it."""
    cfg = get_config(canonical(arch))
    shape = INPUT_SHAPES[shape_name]
    if layers:
        cfg = cfg.replace(num_layers=layers)
    if shape.kind == "train":
        cfg = cfg.replace(remat="full", q_chunk=128)
    if cfg.num_experts:
        cfg = cfg.replace(moe_impl="expert_parallel")
    mesh = dryrun.MESHES["pod16x16"]
    rules = make_rules(mesh, context_parallel_kv=shape.name == "long_500k",
                       overrides=overrides)
    model, axes, p_shard = param_specs(cfg, mesh, rules)
    params = dict(model.named_parameters())
    trees = [(params, p_shard)]
    if shape.kind == "train":
        opt, o_shard = opt_state_specs(params, axes, p_shard)
        trees += [(opt.momentum, o_shard.momentum),
                  (opt.second, o_shard.second),
                  train_batch_specs(cfg, shape, mesh, rules)]
    else:
        spec, d_shard = decode_specs(cfg, shape, mesh, rules)
        trees += [(spec["token"], d_shard["token"]),
                  (spec["cache"], d_shard["cache"])]
    pairs = [p for t, s in trees for p in _pairs(t, s)]
    total = sum(math.prod(local_shape(t.shape, s.placements, mesh))
                * t.element_size() for t, s in pairs)
    return total, len(pairs)


def _pairs(tree, shardings):
    """(tensor, its ``Sharding``) of nested dicts with the same keys."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _pairs(v, shardings[k])
    else:
        yield tree, shardings


@pytest.mark.parametrize("arch,shape,layers", [
    ("yi_6b", "decode_32k", None),
    ("qwen3_moe_235b", "decode_32k", 2),
    ("yi_6b", "train_4k", 2),
    # 24 heads on a 16-way 'model' axis: Muon Split's heads regathered
    ("minitron_4b", "train_4k", 1),
    # one token, which the batch axes do not divide: the dense MoE path
    ("kimi_k2_1t", "long_500k", 2)])
def test_pod_step_is_counted(arch, shape, layers, tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path)
    rec = dryrun.run_one(arch, shape, mesh="pod16x16", num_layers=layers,
                         verbose=False)
    saved = (tmp_path / f"{arch}_{shape}_pod16x16.json").read_text()
    assert "not_ported" not in saved and json.loads(saved)["step"] == \
        "counted"
    assert rec["chips"] == 256 and rec["mesh_shape"] == [16, 16]
    for term in ("compute_s", "memory_s", "collective_s"):
        assert rec[term] > 0
    assert rec["dominant"] == max(("compute", "memory", "collective"),
                                  key=lambda t: rec[f"{t}_s"])
    # each term over the port's own constants, named in the record
    assert rec["collective_s"] == pytest.approx(
        rec["collective_bytes_per_device"] / analysis.LINK_BW)
    assert analysis.LINK_BW in rec["constants"].values()
    assert rec["compute_s"] == pytest.approx(
        rec["flops_per_device"] / analysis.PEAK_FLOPS)
    want, n = _placement_bytes(arch, shape, layers)
    assert abs(rec["argument_bytes"] - want) <= 512 * n
    assert rec["peak_memory_bytes"] > rec["argument_bytes"]
    assert 0 < rec["useful_ratio"] <= 1.0
    if "moe" in arch:             # the EP layers' sums over 'model'
        assert rec["collectives"]["_counts"]["all-reduce"] >= layers


@pytest.mark.parametrize("arch,shape", [("yi_6b", "decode_32k"),
                                        ("minitron_4b", "prefill_32k")])
def test_per_device_flops_add_up_to_one_device(arch, shape, monkeypatch):
    """The per-device count against the one-device count of the same
    step (1 layer, with DSA): on a (4, 1) mesh every matrix product
    divides over the batch, so 4 ranks' FLOPs are exactly one device's (a
    counter that counted the whole step on each rank, or DTensor's shape
    propagation beside the local ops, would be 4x or 2x); on (2, 2) no
    product is counted short (the rules replicate some over 'model')."""
    monkeypatch.setitem(dryrun.MESHES, "data4",
                        MeshShape(("data", "model"), (4, 1)))
    monkeypatch.setitem(dryrun.MESHES, "mesh2x2",
                        MeshShape(("data", "model"), (2, 2)))
    one, data4, mesh2x2 = (dryrun.run_one(arch, shape, mesh=m, num_layers=1,
                                          verbose=False, save=False)
                           ["flops_per_device"]
                           for m in ("h100", "data4", "mesh2x2"))
    assert one > 0
    assert 4 * data4 == pytest.approx(one, rel=1e-12)
    assert 4 * mesh2x2 >= one


@pytest.mark.parametrize("kv_model", [False, True])
def test_pod_cache_overrides(kv_model, tmp_path, monkeypatch):
    """``long_500k`` shards the cache length over 'data'
    (``context_parallel_kv``); ``decode_kv_model`` over 'model'."""
    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path)
    shape = "decode_32k" if kv_model else "long_500k"
    rec = dryrun.run_one("yi_6b", shape, mesh="pod16x16", num_layers=1,
                         decode_kv_model=kv_model, verbose=False)
    overrides = {"kv_seq": "model"} if kv_model else None
    want, n = _placement_bytes("yi_6b", shape, 1, overrides)
    assert abs(rec["argument_bytes"] - want) <= 512 * n
    plain, _ = _placement_bytes("yi_6b", shape, 1,
                                {"kv_seq": None, "batch": ("pod", "data")})
    assert rec["argument_bytes"] < plain
    assert rec["step"] == "counted" and rec["collective_s"] > 0


def test_collectives_of_a_sharded_layer_by_hand():
    """An MLP placed on a (2, 2) mesh: w_up (64, 128) ('embed_fsdp',
    'mlp') is gathered over 'data' (64 x 64 fp32 a rank after it), w_down
    (128, 64) likewise, and the output, a part of a sum over 'model'
    (the contraction over 'mlp'), is all-reduced there when the batch
    constraint makes it whole: three collectives of 16384 B over groups of
    2, each rank's 2 x 64 x 64 x 64 x 2 FLOPs."""
    with tmesh.fake_mesh(MeshShape(("data", "model"), (2, 2))) as mesh:
        rules = make_rules(mesh)
        layer = MLP(64, 128, "gelu", device="meta")
        place_params(layer, mesh, rules, axes=MLP.AXES)
        x = place_batch({"x": torch.empty(8, 16, 64, device="meta")},
                        mesh, rules)["x"]

        def f(x):
            return constrain_batch(mlp(layer, x, "gelu"), mesh)
        y, c = counting.count(f, x, arguments=(layer, x))
        with CommDebugMode() as comm:
            f(x)
    assert c.collectives == [("all-gather", 16384, 2),
                             ("all-gather", 16384, 2),
                             ("all-reduce", 16384, 2)]
    assert {str(k): v for k, v in comm.get_comm_counts().items()} == {
        "c10d_functional.all_gather_into_tensor": 2,
        "c10d_functional.all_reduce": 1}
    assert c.flops == 2 * 2 * 64 * 64 * 64
    assert c.argument_bytes == (2 * 32 * 64 + 4 * 16 * 64) * 4
    wire = analysis.collective_bytes(c.collectives)
    np.testing.assert_allclose(wire["all-gather"], 2 * 16384 / 2)
    np.testing.assert_allclose(wire["all-reduce"], 16384 * 2.0 / 2)
    assert tuple(y.shape) == (8, 16, 64)


def _wrappers():
    from repro_torch.kernels.chunked_ce import kernel as K10
    from repro_torch.kernels.flash_attention import kernel as K9
    from repro_torch.kernels.lightning_indexer import kernel as K7
    from repro_torch.kernels.mamba_scan import kernel as K11
    from repro_torch.kernels.paged_attention import kernel as KD
    from repro_torch.kernels.paged_attention import prefill as KP
    from repro_torch.kernels.sparse_attention import kernel as K8
    return {"paged_decode_gqa": (KD.paged_decode_gqa, 5, {}),
            "paged_prefill_gqa": (KP.paged_prefill_gqa, 5, {"groups": 1}),
            "paged_decode_mla": (KD.paged_decode_mla, 6, {"scale": 1.0}),
            "paged_prefill_mla": (KP.paged_prefill_mla, 6,
                                  {"heads": 1, "scale": 1.0}),
            "paged_indexer_scores_kernel": (
                KD.paged_indexer_scores_kernel, 5, {}),
            "paged_prefill_indexer": (KP.paged_prefill_indexer, 5,
                                      {"heads": 1}),
            "lightning_indexer": (K7.lightning_indexer, 3,
                                  {"heads": 1, "head_dim": 4}),
            "block_sparse_attention": (K8.block_sparse_attention, 5,
                                       {"block_size": 4}),
            "flash_attention": (K9.flash_attention, 3, {}),
            "chunked_ce": (K10.chunked_ce, 4, {}),
            "mamba_scan": (K11.mamba_scan, 4, {}),
            "mamba_scan_model": (K11.mamba_scan_model, 6, {}),
            "mamba_scan_heads": (K11.mamba_scan_heads, 6, {})}


@pytest.mark.parametrize("name", list(_wrappers()))
def test_kernel_wrappers_refuse_dtensors(name):
    """Every hand-written kernel's wrapper raises on a ``DTensor`` (its
    pointer would be a local shard's) instead of running its plain
    version: placed callers hand it local tensors."""
    fn, n_args, kw = _wrappers()[name]
    with tmesh.fake_mesh(MeshShape(("data", "model"), (1, 1))) as mesh:
        x = place_batch({"x": torch.zeros(2, 4)}, mesh,
                        make_rules(mesh))["x"]
        with pytest.raises(TypeError, match="DTensor"):
            fn(*([x] * n_args), **kw)
