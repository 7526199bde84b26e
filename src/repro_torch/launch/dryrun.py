"""Dry run: every (architecture x input shape) on one H100, without
allocating.

Port of ``repro.launch.dryrun``.  On the mesh ``h100`` (the default: one
card, 1 x 1 ``('data', 'model')``) it builds the model on ``meta`` at full
width and depth, in bf16, drives the real step of ``launch.steps`` —
``make_train_step`` with Muon for ``train_4k`` (remat on, as the
reference's production training), ``make_prefill_step`` for
``prefill_32k``, ``make_serve_step`` for the decode shapes — on abstract
inputs, and counts it op by op (``roofline.counting``): the roofline
terms (``roofline.analyze``, the H100's constants), ``dominant``,
``model_flops``, ``useful_ratio``, the argument / temp / output / peak
bytes, ``param_bytes_global``, and the meta run's seconds in the place of
the reference's lower and compile seconds.  The step's collectives go
through a process group of one rank on the CPU (started here when there
is none), so they are counted as the card would run them: a group of one
rank moves no wire bytes.

An MoE arch runs with ``moe_impl="expert_parallel"``: the routed path
reads the expert counts back to the host, which abstract tensors cannot
do; the record says so (``moe_impl``).

On the pod meshes (``pod16x16`` (16, 16) and ``pod2x16x16`` (2, 16, 16),
the reference's) the same step runs sharded: a fake process group of 256
/ 512 ranks (``launch.mesh.fake_mesh``; this process is rank 0 and a
collective moves nothing), the model on ``meta`` placed over it
(``sharding.rules.place_params``), Muon's state, the batch and the cache
placed by their rules, and the step counted op by op on rank 0's local
shards: per-device FLOPs and bytes, and every collective — the EP
layer's sum over 'model', and those DTensor inserts to redistribute —
with its buffer bytes and group size.  ``collective_s`` divides their
wire bytes by the port's own link rate (``roofline.analysis.LINK_BW``,
NVLink 4, each direction; the record names it).  The fake group's mesh
is a CPU mesh, on which DTensor moves a shard from one tensor dimension
to another by an all-gather where NCCL would use an all-to-all; the
record says so (``collective_note``).  The reference's overrides hold:
``long_500k`` shards the cache length over 'data'
(``context_parallel_kv``), and ``decode_kv_model`` shards it over 'model'
on the decode shapes.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b \\
      --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm-5 \\
      --shape train_4k --mesh pod16x16 --num-layers 4 --muon-sharded-ns
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod-too]

Records go to ``experiments/dryrun_torch/<arch>_<shape>_<mesh>.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import ARCH_IDS, canonical, get_config
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.launch.mesh import (destroy_host_mesh, fake_mesh,
                                     make_host_mesh, production_mesh_shape)
from repro_torch.launch.specs import (decode_specs, opt_state_specs,
                                      param_specs, skip_reason,
                                      train_batch_specs)
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.optim.muon import MuonState
from repro_torch.roofline import analyze, model_flops
from repro_torch.roofline.counting import count, held_bytes
from repro_torch.sharding.rules import (MeshShape, make_rules, place_params,
                                        place_tree)
from repro_torch.utils import tree_bytes

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

MESHES = {"h100": MeshShape(("data", "model"), (1, 1)),
          "pod16x16": production_mesh_shape(),
          "pod2x16x16": production_mesh_shape(multi_pod=True)}

EP_NOTE = ("expert_parallel: the routed path reads the expert counts back "
           "to the host, which meta tensors cannot")
CPU_MESH_NOTE = ("counted on a CPU mesh of the fake process group: DTensor "
                 "moves a shard between tensor dimensions by all-gather "
                 "there, where NCCL would use all-to-all")


def _step_counts(cfg, shape, model, axes, p_shard, mesh, rules, step_mesh,
                 *, placed: bool, muon_sharded_ns: bool = False):
    """Run the shape's step on ``model`` (on ``meta``) under the counters;
    ``placed``: place the model, Muon's state, the batch and the cache
    over ``mesh`` first.  Returns (counts, the bytes the step updates in
    place)."""
    if placed:
        place_params(model, mesh, rules, axes)

    def put(tree, shardings):
        return place_tree(tree, shardings) if placed else tree
    params = dict(model.named_parameters())
    if shape.kind == "train":
        opt, o_shard = opt_state_specs(params, axes, p_shard)
        opt = MuonState(put(opt.momentum, o_shard.momentum),
                        put(opt.second, o_shard.second))
        batch, b_shard = train_batch_specs(cfg, shape, mesh, rules)
        batch = put(batch, b_shard)
        step = make_train_step(model, mesh=step_mesh,
                               muon_sharded_ns=muon_sharded_ns)
        inputs = (params, opt.momentum, opt.second, batch)
        _, counts = count(step, opt, batch, arguments=inputs)
        return counts, held_bytes((params, opt.momentum, opt.second))
    if shape.kind == "prefill":
        batch, b_shard = train_batch_specs(cfg, shape, mesh, rules)
        keep = [k for k in batch if k not in ("targets", "loss_mask")]
        batch = put({k: batch[k] for k in keep},
                    {k: b_shard[k] for k in keep})
        _, counts = count(make_prefill_step(model, mesh=step_mesh), batch,
                          arguments=(params, batch))
        return counts, 0
    spec, d_shard = decode_specs(cfg, shape, mesh, rules)
    token, cache = put(spec["token"], d_shard["token"]), \
        put(spec["cache"], d_shard["cache"])
    _, counts = count(make_serve_step(model, mesh=step_mesh), token, cache,
                      spec["cache_index"], arguments=(params, token, cache))
    return counts, held_bytes(cache)


def _record(counts, alias, seconds, cfg, shape, arch, shape_name,
            mesh_name, params) -> dict:
    roof = analyze(counts, arch=arch, shape=shape_name, mesh_name=mesh_name,
                   chips=MESHES[mesh_name].size(),
                   model_flops=model_flops(cfg, shape))
    rec = roof.to_dict()
    rec.update({
        "status": "ok", "step": "counted",
        "meta_run_s": round(seconds, 2),
        "param_bytes_global": tree_bytes(params),
        "memory_analysis": {
            "argument_size_in_bytes": counts.argument_bytes,
            "output_size_in_bytes": counts.output_bytes,
            "temp_size_in_bytes": counts.peak_bytes - counts.argument_bytes,
            "alias_size_in_bytes": alias,
        },
    })
    return rec


def _pod_record(cfg, shape, arch, shape_name, mesh_name, rules,
                muon_sharded_ns: bool) -> dict:
    """The sharded step on a pod mesh, counted on rank 0 of a fake
    process group (see the module's docstring)."""
    destroy_host_mesh()
    with fake_mesh(MESHES[mesh_name]) as mesh:
        t0 = time.perf_counter()
        model, axes, p_shard = param_specs(cfg, mesh, rules)
        global_params = [torch.empty(p.shape, dtype=p.dtype, device="meta")
                         for p in model.parameters()]
        counts, alias = _step_counts(cfg, shape, model, axes, p_shard, mesh,
                                     rules, mesh, placed=True,
                                     muon_sharded_ns=muon_sharded_ns)
        seconds = time.perf_counter() - t0
    rec = _record(counts, alias, seconds, cfg, shape, arch, shape_name,
                  mesh_name, global_params)
    rec["collective_note"] = CPU_MESH_NOTE
    return rec


def _counted_record(cfg, shape, arch, shape_name, mesh_name, rules) -> dict:
    """The step run on ``meta`` under the counters (one rank)."""
    mesh = MESHES[mesh_name]
    host = make_host_mesh("cpu")
    t0 = time.perf_counter()
    model, axes, p_shard = param_specs(cfg, mesh, rules)
    counts, alias = _step_counts(cfg, shape, model, axes, p_shard, mesh,
                                 rules, host, placed=False)
    return _record(counts, alias, time.perf_counter() - t0, cfg, shape,
                   arch, shape_name, mesh_name, model)


def run_one(arch: str, shape_name: str, *, mesh: str = "h100",
            fsdp: bool = True, selector: str = None, num_layers: int = None,
            global_batch: int = None, muon_sharded_ns: bool = False,
            decode_kv_model: bool = False, verbose: bool = True,
            save: bool = True) -> dict:
    """One record; ``num_layers`` / ``global_batch`` cut the depth / batch
    (listed under ``reduced``); ``muon_sharded_ns`` and
    ``decode_kv_model`` are the reference's options (the pod meshes)."""
    arch = canonical(arch)
    cfg = get_config(arch)
    if selector and cfg.dsa is not None:
        cfg = cfg.replace(dsa=dataclasses.replace(cfg.dsa, selector=selector))
    shape = INPUT_SHAPES[shape_name]
    reduced = {}
    if num_layers is not None:
        reduced["num_layers"] = [cfg.num_layers, num_layers]
        cfg = cfg.replace(num_layers=num_layers)
    if global_batch is not None:
        reduced["global_batch"] = [shape.global_batch, global_batch]
        shape = dataclasses.replace(shape, global_batch=global_batch)
    if shape.kind == "train":
        # production training always remats (paper §2.4.1), a checkpoint a
        # layer group, with the reference's dry-run q_chunk
        cfg = cfg.replace(remat="full", q_chunk=128)
    if cfg.num_experts:
        cfg = cfg.replace(moe_impl="expert_parallel")
    tag = f"{arch}_{shape_name}_{mesh}"
    base = {"arch": arch, "shape": shape_name, "mesh": mesh,
            "mesh_shape": list(MESHES[mesh].shape),
            "chips": MESHES[mesh].size(), "reduced": reduced,
            "moe_impl": EP_NOTE if cfg.num_experts else cfg.moe_impl,
            "torch": torch.__version__}
    skip = skip_reason(cfg, shape)
    if skip:
        rec = dict(base, status="skipped", reason=skip)
        if save:
            _save(tag, rec)
        if verbose:
            print(f"[skip] {tag}: {skip}")
        return rec
    overrides = {}
    if decode_kv_model and shape.kind == "decode":
        # the reference's DP-attention adaptation: the cache length over
        # 'model' (kv-head counts below 16 cannot shard heads)
        overrides["kv_seq"] = "model"
    rules = make_rules(MESHES[mesh], fsdp=fsdp,
                       context_parallel_kv=(shape.name == "long_500k"
                                            and cfg.family not in
                                            ("ssm", "hybrid")),
                       overrides=overrides)
    if mesh == "h100":
        rec = _counted_record(cfg, shape, arch, shape_name, mesh, rules)
    else:
        rec = _pod_record(cfg, shape, arch, shape_name, mesh, rules,
                          muon_sharded_ns)
    rec = dict(base, **rec)
    if save:
        _save(tag, rec)
    if verbose:
        print(f"[ok] {tag}: dominant={rec['dominant']} "
              f"compute={rec['compute_s']:.4f}s "
              f"memory={rec['memory_s']:.4f}s "
              f"collective={rec['collective_s']:.4f}s "
              f"peak={rec['peak_memory_bytes'] / 2**30:.2f}GiB "
              f"(meta run {rec['meta_run_s']:.0f}s)", flush=True)
    return rec


def _save(tag: str, rec: dict):
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    with open(OUT_DIR / f"{tag}.json", "w") as f:
        json.dump(rec, f, indent=1, default=str)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(INPUT_SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", default="h100", choices=list(MESHES))
    ap.add_argument("--multi-pod", action="store_true",
                    help="the (2, 16, 16) mesh: --mesh pod2x16x16")
    ap.add_argument("--multi-pod-too", action="store_true",
                    help="run each combo on every mesh")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--selector", default=None, choices=[None, "token",
                                                         "block"])
    ap.add_argument("--num-layers", type=int, default=None,
                    help="cut the depth (listed under 'reduced')")
    ap.add_argument("--muon-sharded-ns", action="store_true")
    ap.add_argument("--decode-kv-model", action="store_true")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.all else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = list(MESHES) if args.multi_pod_too else \
        ["pod2x16x16" if args.multi_pod else args.mesh]

    failures = []
    t0 = time.perf_counter()
    try:
        for arch in archs:
            for shape in shapes:
                for mesh in meshes:
                    try:
                        run_one(arch, shape, mesh=mesh,
                                fsdp=not args.no_fsdp,
                                selector=args.selector,
                                num_layers=args.num_layers,
                                muon_sharded_ns=args.muon_sharded_ns,
                                decode_kv_model=args.decode_kv_model)
                    except Exception as e:  # noqa: BLE001
                        failures.append((arch, shape, mesh, repr(e)))
                        print(f"[FAIL] {arch} {shape} {mesh}: {e}")
                        traceback.print_exc()
    finally:
        destroy_host_mesh()
    print(f"\n{len(archs) * len(shapes) * len(meshes)} records in "
          f"{time.perf_counter() - t0:.1f} s")
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print("\nall dry-runs OK")


if __name__ == "__main__":
    main()
