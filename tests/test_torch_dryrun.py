"""PyTorch port: the analysis layer (``utils``, ``launch.specs``,
``roofline``, ``launch.dryrun``) against the JAX package.

* ``utils``: sizes, bytes, stacking and abstract copies as the reference's;
* ``active_param_count`` and ``model_flops`` equal the reference's for all
  eleven FULL configs x the four input shapes; ``skip_reason`` too;
* ``launch.specs``: the train batch's shapes and dtypes, the decode
  cache's leaf shapes and its placements (the reference's ``cache_specs``
  resolved on a stub of the multi-pod mesh, ``context_parallel_kv`` at
  ``long_500k``), and the parameter bytes equal the reference's abstract
  specs for every arch; Muon's abstract state;
* ``roofline.counting`` on a small function: FLOPs, bytes and a
  collective exactly as counted by hand, the peak live bytes to within
  its 1 % slack; on Yi-6B's smoke
  prefill step (GQA, DSA off) its FLOPs equal the reference's
  ``analyze_hlo`` FLOPs of the same step compiled on the CPU (ratio 1 to
  1e-6: both count the matrix products);
* ``dryrun.run_one`` for yi-6b ``decode_32k`` on ``meta`` at full size
  writes a record with the reference's fields; a pod mesh's record holds
  the per-device bytes its placements decide, its step ``not_ported``;
* K11's forwards on ``meta`` are one op each: the plain versions' output
  shapes, dtypes and FLOPs, the kernel's bytes (inputs read once, outputs
  written once); so the scan archs' ``prefill_32k`` steps are counted
  (falcon-mamba at full depth, zamba2 at one group of layers).

The process group is ended after the file.
"""
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import Replicate, Shard

from repro import configs as jconfigs
from repro.configs.base import INPUT_SHAPES as J_SHAPES
from repro.launch import specs as jspecs
from repro.launch import steps as jsteps
from repro.models import get_model as jax_get_model
from repro.roofline import analysis as janalysis
from repro.roofline.hlo_parse import analyze_hlo
from repro.sharding import rules as jrules
from repro_torch import utils
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.launch import dryrun, specs
from repro_torch.launch import mesh as tmesh
from repro_torch.kernels.mamba_scan import kernel as scan_kernel
from repro_torch.kernels.mamba_scan import ref as scan_ref
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import get_model
from repro_torch.roofline import analysis, counting
from repro_torch.sharding import rules as trules
from _torch_threads import one_torch_thread  # noqa: F401

MULTI_POD = (("pod", "data", "model"), (2, 16, 16))


@pytest.fixture(scope="module", autouse=True)
def _end_process_group():
    yield
    tmesh.destroy_host_mesh()
    assert not dist.is_initialized()


def test_utils_match_reference():
    from repro import utils as jutils
    tree = {"a": np.ones((2, 3), np.float32),
            "b": {"c": np.zeros((4,), np.int32)}}
    ttree = {"a": torch.ones(2, 3), "b": {"c": torch.zeros(4,
                                                         dtype=torch.int32)}}
    jtree = jax.tree.map(jnp.asarray, tree)
    assert utils.tree_bytes(ttree) == jutils.tree_bytes(jtree)
    assert utils.tree_size(ttree) == jutils.tree_size(jtree)
    got = utils.stack_tree(ttree, 5, abstract=True)
    want = jutils.stack_tree(jtree, 5, abstract=True)
    assert got["a"].shape == want["a"].shape and got["a"].is_meta
    np.testing.assert_array_equal(utils.stack_tree(ttree, 2)["a"].numpy(),
                                  np.asarray(jutils.stack_tree(jtree, 2)["a"]))
    assert utils.abstract_like(ttree)["b"]["c"].dtype == torch.int32
    assert utils.zeros((3, 2), torch.bfloat16, abstract=True).is_meta
    assert utils.zeros((3, 2), torch.float32).abs().sum() == 0


def test_input_shapes_match_reference():
    assert {k: vars(v) for k, v in INPUT_SHAPES.items()} == \
        {k: vars(v) for k, v in J_SHAPES.items()}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_and_skips_match_reference(arch):
    cfg, jcfg = get_config(arch), jconfigs.get_config(arch)
    assert analysis.active_param_count(cfg) == \
        janalysis.active_param_count(jcfg)
    for name, shape in INPUT_SHAPES.items():
        assert analysis.model_flops(cfg, shape) == \
            janalysis.model_flops(jcfg, J_SHAPES[name])
        assert specs.skip_reason(cfg, shape) == \
            jspecs.skip_reason(jcfg, J_SHAPES[name])


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_reference(arch):
    cfg, jcfg = get_config(arch), jconfigs.get_config(arch)
    names, shape = MULTI_POD
    stub = types.SimpleNamespace(axis_names=names,
                                 devices=np.empty(shape, dtype=np.int8))
    mesh = trules.MeshShape(names, shape)
    # the train batch
    for sname in ("train_4k", "prefill_32k"):
        batch, shard = specs.train_batch_specs(
            cfg, INPUT_SHAPES[sname], mesh, trules.make_rules(mesh))
        B, S = INPUT_SHAPES[sname].global_batch, INPUT_SHAPES[sname].seq_len
        assert batch["tokens"].shape[0] == B
        text = S - (cfg.frontend_tokens if cfg.family == "vlm" else 0)
        assert batch["tokens"].shape == (B, text)
        assert batch["tokens"].dtype == torch.int32
        assert shard["tokens"].placements == (Shard(0), Shard(0),
                                              Replicate())
    # the decode cache: leaf shapes and placements
    for sname in ("decode_32k", "long_500k"):
        if specs.skip_reason(cfg, INPUT_SHAPES[sname]):
            continue
        cp = sname == "long_500k" and cfg.family not in ("ssm", "hybrid")
        jr = jrules.make_rules(stub, context_parallel_kv=cp)
        rules = trules.make_rules(mesh, context_parallel_kv=cp)
        sh = INPUT_SHAPES[sname]
        got, got_sh = specs.decode_specs(cfg, sh, mesh, rules)
        jc, jaxes = jax_get_model(jcfg).init_cache(
            jcfg, sh.global_batch, sh.seq_len, dtype=jnp.bfloat16,
            abstract=True)
        leaves, want_axes = _flat(got["cache"]), _flat(jaxes)
        jleaves = _flat(jc)
        placements = _flat(got_sh["cache"])
        assert set(leaves) == set(jleaves)
        for k, leaf in leaves.items():
            assert tuple(leaf.shape) == tuple(jleaves[k].shape), k
            assert leaf.dtype == torch.bfloat16
            spec = jrules.resolve_spec(want_axes[k], jleaves[k].shape, jr,
                                       stub)
            owner = {a: d for d, ax in enumerate(spec) for a in
                     (ax if isinstance(ax, tuple) else (ax,))
                     if a is not None}
            want = tuple(Shard(owner[a]) if a in owner else Replicate()
                         for a in names)
            assert placements[k].placements == want, (arch, sname, k)
    # the parameters and Muon's state
    model, axes, p_shard = specs.param_specs(cfg, mesh,
                                             trules.make_rules(mesh))
    jparams, _ = jax_get_model(jcfg).init(jax.random.key(0), jcfg,
                                          dtype=jnp.bfloat16, abstract=True)
    assert utils.tree_bytes(model) == sum(
        x.size * x.dtype.itemsize for x in jax.tree.leaves(jparams))
    params = dict(model.named_parameters())
    opt, o_shard = specs.opt_state_specs(params, axes, p_shard)
    assert set(opt.momentum) == set(params) == set(o_shard.momentum)
    assert set(opt.second) < set(params) and opt.second
    assert all(t.dtype == torch.float32 and t.device.type == "meta"
               for t in utils.leaves((opt.momentum, opt.second)))


def test_counting_by_hand():
    x = torch.empty(64, 32, device="meta")
    w = torch.empty(32, 16, device="meta")
    mesh = tmesh.make_host_mesh("cpu")

    def f(x, w):
        y = x @ w
        z = torch.relu(y)
        return funcol.all_reduce(z.sum(), "sum", mesh.get_group("model"))

    out, c = counting.count(f, x, w, arguments=(x, w))
    assert c.flops == 2 * 64 * 32 * 16
    # mm reads x, w, writes y; relu y -> z; sum z -> scalar; all_reduce
    # reads and writes the scalar
    assert c.bytes == (64 * 32 + 32 * 16 + 64 * 16) * 4 + 2 * 64 * 16 * 4 \
        + (64 * 16 + 1) * 4 + 2 * 4
    assert c.argument_bytes == (64 * 32 + 32 * 16) * 4
    # y and z, then three scalars: the sum, the all-reduce's output and
    # the copy its autograd wrapper makes on meta; to within PEAK_SLACK
    peak = 2 * 64 * 16 * 4 + 3 * 4
    assert peak * (1 - counting.PEAK_SLACK) <= \
        c.peak_bytes - c.argument_bytes <= peak
    assert c.collectives == [("all-reduce", 4, 1)]
    colls = analysis.collective_bytes(c.collectives)
    assert colls["all-reduce"] == 0.0 and colls["_counts"] == {
        "all-reduce": 1}
    assert analysis.collective_bytes([("all-reduce", 100, 4)])[
        "all-reduce"] == 100 * 2.0 * 3 / 4


def test_counted_flops_match_reference_hlo():
    jcfg = jconfigs.get_smoke_config("yi_6b").replace(dsa=None)
    params, _ = jax_get_model(jcfg).init(jax.random.key(0), jcfg)
    B, S = 2, 64
    txt = jax.jit(jsteps.make_prefill_step(jcfg)).lower(
        params, {"tokens": jnp.zeros((B, S), jnp.int32)}).compile().as_text()
    want = analyze_hlo(txt).flops
    cfg = get_smoke_config("yi_6b").replace(dsa=None)
    model = get_model(cfg).init(cfg, device="meta")
    tokens = torch.empty(B, S, dtype=torch.int32, device="meta")
    _, c = counting.count(make_prefill_step(model), {"tokens": tokens},
                          arguments=(model, tokens))
    assert want > 0
    np.testing.assert_allclose(c.flops / want, 1.0, rtol=1e-6)


def test_run_one_records(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path)
    rec = dryrun.run_one("yi-6b", "decode_32k", verbose=False)
    saved = json.loads((tmp_path / "yi_6b_decode_32k_h100.json").read_text())
    ref_fields = {f.name for f in
                  janalysis.Roofline.__dataclass_fields__.values()}
    assert ref_fields <= set(saved)
    assert {"status", "param_bytes_global", "memory_analysis"} <= set(saved)
    assert set(saved["memory_analysis"]) == {
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "alias_size_in_bytes"}
    assert rec["status"] == "ok" and rec["step"] == "counted"
    assert rec["chips"] == 1 and rec["mesh"] == "h100"
    cfg, shape = get_config("yi_6b"), INPUT_SHAPES["decode_32k"]
    assert rec["model_flops"] == analysis.model_flops(cfg, shape)
    cache = get_model(cfg).init_cache(cfg, shape.global_batch,
                                      shape.seq_len, dtype=torch.bfloat16,
                                      device="meta")
    # arguments: the bf16 parameters, the token and the cache
    assert rec["argument_bytes"] == rec["param_bytes_global"] \
        + shape.global_batch * 4 + utils.tree_bytes(cache)
    assert rec["peak_memory_bytes"] > rec["argument_bytes"]
    assert rec["dominant"] == "memory" and rec["collective_s"] == 0.0
    assert 0 < rec["useful_ratio"] <= 1.0
    # the multi-pod mesh: what the placements decide, per device
    pod = dryrun.run_one("kimi-k2-1t-a32b", "train_4k", mesh="pod2x16x16",
                         verbose=False)
    assert pod["step"] == "not_ported" and pod["chips"] == 512
    per = pod["per_device"]
    assert 0 < per["param_bytes"] < pod["param_bytes_global"] / 16
    assert per["opt_state_bytes"] > per["param_bytes"]
    assert per["batch_bytes"] == 256 * 4096 * (4 + 4 + 4) // 32


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


# each K11 forward, its plain version and abstract inputs at B 2, S 130
_BF16 = torch.bfloat16
K11_FORMS = {
    "mamba_scan": (scan_kernel.mamba_scan, scan_ref.reference, lambda: (
        _meta(2, 130, 48, 4, dtype=_BF16), _meta(2, 130, 48, 4, dtype=_BF16),
        _meta(2, 130, 4, dtype=_BF16), _meta(2, 48, 4, dtype=_BF16))),
    "mamba_scan_model": (scan_kernel.mamba_scan_model, scan_ref.scan_model,
                         lambda: (_meta(2, 130, 48), _meta(48, 16),
                                  _meta(2, 130, 48, dtype=_BF16),
                                  _meta(2, 130, 16, dtype=_BF16),
                                  _meta(2, 130, 16, dtype=_BF16),
                                  _meta(2, 48, 16))),
    "mamba_scan_heads": (scan_kernel.mamba_scan_heads, scan_ref.scan_heads,
                         lambda: (_meta(2, 130, 4), _meta(4),
                                  _meta(2, 130, 4 * 64, dtype=_BF16),
                                  _meta(2, 130, 16, dtype=_BF16),
                                  _meta(2, 130, 16, dtype=_BF16),
                                  _meta(2, 4, 64, 16, dtype=_BF16))),
}


@pytest.mark.parametrize("form", list(K11_FORMS))
def test_k11_forwards_on_meta_are_one_op(form):
    fn, plain, make = K11_FORMS[form]
    args = make()
    out, c = counting.count(fn, *args, arguments=args)
    want, cp = counting.count(plain, *args, arguments=args)
    for o, w in zip(out, want):
        assert o.is_meta and o.shape == w.shape and o.dtype == w.dtype
    assert c.flops == cp.flops
    if form == "mamba_scan_heads":     # y = h·C a step, as the reference
        B, S, H = args[0].shape
        assert c.flops == 2 * B * S * args[2].shape[-1] * args[3].shape[-1]
    assert c.bytes == sum(counting._nbytes(t) for t in (*args, *out))
    assert c.bytes < cp.bytes


@pytest.mark.parametrize("arch,layers", [("falcon-mamba-7b", None),
                                         ("zamba2-2.7b", 6)])
def test_run_one_scan_archs_at_32k(tmp_path, monkeypatch, arch, layers):
    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path)
    rec = dryrun.run_one(arch, "prefill_32k", num_layers=layers,
                         verbose=False)
    assert rec["status"] == "ok" and rec["step"] == "counted"
    cfg = get_config(arch)
    assert rec["reduced"] == ({} if layers is None else
                              {"num_layers": [cfg.num_layers, layers]})
    assert rec["model_flops"] == analysis.model_flops(
        cfg.replace(num_layers=layers or cfg.num_layers),
        INPUT_SHAPES["prefill_32k"])
    assert rec["flops_per_device"] > 0
    assert rec["peak_memory_bytes"] > rec["argument_bytes"]
