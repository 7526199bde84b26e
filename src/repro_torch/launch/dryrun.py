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
the reference's) the record holds what placements alone decide: per
device, the parameters', Muon state's, batch's and cache's bytes under
the sharding rules (``sharding.resolve_spec`` over the mesh's shape).
The sharded step on more than one rank is not ported: its terms are
recorded as ``"step": "not_ported"``, not as a number divided by the
chip count.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b \\
      --shape decode_32k
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
from repro_torch.launch.mesh import (destroy_host_mesh, make_host_mesh,
                                     production_mesh_shape)
from repro_torch.launch.specs import (decode_specs, opt_state_specs,
                                      param_specs, skip_reason,
                                      train_batch_specs)
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.roofline import analyze, model_flops
from repro_torch.roofline.counting import count
from repro_torch.sharding.rules import MeshShape, local_shape, make_rules
from repro_torch.utils import tree_bytes

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

MESHES = {"h100": MeshShape(("data", "model"), (1, 1)),
          "pod16x16": production_mesh_shape(),
          "pod2x16x16": production_mesh_shape(multi_pod=True)}

EP_NOTE = ("expert_parallel: the routed path reads the expert counts back "
           "to the host, which meta tensors cannot")


def _local_bytes(tree, shardings, mesh) -> int:
    """Bytes one rank holds of ``tree`` under ``shardings`` (same keys)."""
    if isinstance(tree, dict):
        return sum(_local_bytes(v, shardings[k], mesh)
                   for k, v in tree.items())
    n = 1
    for d in local_shape(tree.shape, shardings.placements, mesh):
        n *= d
    return n * tree.element_size()


def _placement_record(cfg, shape, mesh, rules) -> dict:
    """Per-device bytes that the placements alone decide on ``mesh``."""
    model, axes, p_shard = param_specs(cfg, mesh, rules)
    params = dict(model.named_parameters())
    per = {"param_bytes": _local_bytes(params, p_shard, mesh)}
    if shape.kind == "train":
        opt, o_shard = opt_state_specs(params, axes, p_shard)
        per["opt_state_bytes"] = (
            _local_bytes(opt.momentum, o_shard.momentum, mesh)
            + _local_bytes(opt.second, o_shard.second, mesh))
    if shape.kind in ("train", "prefill"):
        batch, b_shard = train_batch_specs(cfg, shape, mesh, rules)
        per["batch_bytes"] = _local_bytes(batch, b_shard, mesh)
    else:
        spec, d_shard = decode_specs(cfg, shape, mesh, rules)
        per["cache_bytes"] = _local_bytes(spec["cache"], d_shard["cache"],
                                          mesh)
        per["token_bytes"] = _local_bytes(spec["token"], d_shard["token"],
                                          mesh)
    return {"status": "ok", "step": "not_ported",
            "param_bytes_global": tree_bytes(params), "per_device": per,
            "note": "the sharded step on more than one rank is not ported; "
                    "these bytes are what the placements alone decide"}


def _counted_record(cfg, shape, arch, shape_name, mesh_name, rules) -> dict:
    """The step run on ``meta`` under the counters (one rank)."""
    mesh = MESHES[mesh_name]
    host = make_host_mesh("cpu")
    t0 = time.perf_counter()
    model, axes, p_shard = param_specs(cfg, mesh, rules)
    params = dict(model.named_parameters())
    if shape.kind == "train":
        opt, _ = opt_state_specs(params, axes, p_shard)
        batch, _ = train_batch_specs(cfg, shape, mesh, rules)
        step = make_train_step(model, mesh=host)
        inputs = (params, opt.momentum, opt.second, batch)
        _, counts = count(step, opt, batch, arguments=inputs)
        alias = tree_bytes((params, opt.momentum, opt.second))
    elif shape.kind == "prefill":
        batch, _ = train_batch_specs(cfg, shape, mesh, rules)
        batch = {k: v for k, v in batch.items()
                 if k not in ("targets", "loss_mask")}
        inputs = (params, batch)
        _, counts = count(make_prefill_step(model, mesh=host), batch,
                          arguments=inputs)
        alias = 0
    else:
        spec, _ = decode_specs(cfg, shape, mesh, rules)
        inputs = (params, spec["token"], spec["cache"])
        _, counts = count(make_serve_step(model, mesh=host), spec["token"],
                          spec["cache"], spec["cache_index"],
                          arguments=inputs)
        alias = tree_bytes(spec["cache"])
    seconds = time.perf_counter() - t0
    roof = analyze(counts, arch=arch, shape=shape_name, mesh_name=mesh_name,
                   chips=1, model_flops=model_flops(cfg, shape))
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


def run_one(arch: str, shape_name: str, *, mesh: str = "h100",
            fsdp: bool = True, selector: str = None, num_layers: int = None,
            global_batch: int = None, verbose: bool = True,
            save: bool = True) -> dict:
    """One record; ``num_layers`` / ``global_batch`` cut the depth / batch
    (listed under ``reduced``)."""
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
    rules = make_rules(MESHES[mesh], fsdp=fsdp,
                       context_parallel_kv=(shape.name == "long_500k"
                                            and cfg.family not in
                                            ("ssm", "hybrid")))
    if mesh == "h100":
        rec = _counted_record(cfg, shape, arch, shape_name, mesh, rules)
    else:
        rec = _placement_record(cfg, shape, MESHES[mesh], rules)
    rec = dict(base, **rec)
    if save:
        _save(tag, rec)
    if verbose:
        if rec["step"] == "counted":
            print(f"[ok] {tag}: dominant={rec['dominant']} "
                  f"compute={rec['compute_s']:.4f}s "
                  f"memory={rec['memory_s']:.4f}s "
                  f"collective={rec['collective_s']:.4f}s "
                  f"peak={rec['peak_memory_bytes'] / 2**30:.2f}GiB "
                  f"(meta run {rec['meta_run_s']:.0f}s)", flush=True)
        else:
            per = rec["per_device"]
            print(f"[ok] {tag}: step not ported; per device "
                  + " ".join(f"{k}={v / 2**30:.2f}GiB"
                             for k, v in per.items()), flush=True)
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
                                selector=args.selector)
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
