#!/usr/bin/env python3
"""Study of the bf16 tensor-core attention tile of K2 and K8 on one GPU.

    python3 tile_study.py [--parent DIR]

The tile (``src/repro_torch/csrc/mma_tile.cuh``) splits each tile's key
range over ``parts`` CTAs where the tiles leave CTA slots of the card
empty (``repro_torch.kernels.build.key_split``).  This script measures
that choice and the tile against its yardsticks, in bf16:

  resources  the tile's registers, spills, shared memory and CTAs an SM
             for every instantiation, as the CUDA runtime reports them;
  split      K2 (paged span prefill) and K8 (block-sparse attention) at
             the serve shapes of ``chip_smoke.py`` and at grids of 8 to
             512 tiles: the device time of the C entry point with the key
             range in 1, 2 and 4 parts (CUDA events over back-to-back
             launches), the wrapper's time (CUDA events) and its device
             time (the same calls replayed from a CUDA graph), each held
             against the plain version (``chip_smoke.py``'s bf16 bound);
             at the serve shapes also scaled_dot_product_attention on the
             same inputs (the KV gathered and its heads repeated once,
             before the timed loop);
  parent     with ``--parent DIR``, a copy of another revision's
             ``src/repro_torch/csrc`` (for example ``git archive <commit>
             src/repro_torch/csrc``, unpacked): its K2 and K8 bf16 kernels
             at the serve shapes (called through the C interface that
             revision had, without the split arguments), and its K8 body's
             registers and spills (``nvcc -Xptxas -v``) and SASS
             instruction counts (``cuobjdump -sass``) in bf16 and fp32.

It prints the card's name and power limit first.  It needs a CUDA device
and exits non-zero without one.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import re
import subprocess
import sys
from pathlib import Path

from chip_smoke import _hold, cuda_ms, graph_ms

ROOT = Path(__file__).resolve().parent
SEED = 0


def stream() -> int:
    import torch
    return torch.cuda.current_stream().cuda_stream


def report(kernel, tag, tiles, flops, times) -> None:
    print(f"[split] kernel={kernel} case={tag} tiles={tiles} " + " ".join(
        f"{k}_ms={v:.5f} {k}_tflops={flops / v / 1e9:.1f}"
        for k, v in times.items()), flush=True)


def k2_case(tag, B, KVH, G, d, bs, start, S, parent=None, sdpa=False):
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import prefill as K2
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    nbk = 4096
    kp, vp = (torch.randn((nbk + 1, bs, KVH, d), generator=gen,
                          device="cuda").bfloat16() for _ in range(2))
    mb = (start + S) // bs + 1
    live = (start + S - 1) // bs + 1
    t = np.full((B, mb), nbk, np.int32)
    perm = rng.permutation(nbk)
    for b in range(B):
        t[b, :live] = perm[b * live:(b + 1) * live]
    tables = torch.from_numpy(t).cuda()
    st = torch.full((B,), start, dtype=torch.int32, device="cuda")
    q = torch.randn((B, KVH, S * G, d), generator=gen,
                    device="cuda").bfloat16()
    out = torch.empty_like(q)
    flops = 4 * B * sum(start + i + 1 for i in range(S)) * G * KVH * d
    want = K2.paged_prefill_gqa_plain(q, kp, vp, tables, st, groups=G)
    fn = build.cuda_entry("paged_prefill_gqa")
    tiles = -(-S * G // 64) * KVH * B
    times = {}
    for parts in (1, 2, 4):
        ws = torch.empty(tiles * parts * 64 * (d + 2), device="cuda")

        def call():
            build.check_launch("paged_prefill_gqa", fn(
                1, d, bs, q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                tables.data_ptr(), st.data_ptr(), out.data_ptr(), B, KVH,
                S * G, G, mb, 0, 0.0, d ** -0.5, parts, ws.data_ptr(),
                stream()))
        call()
        torch.cuda.synchronize()
        _hold(f"K2 {tag} parts={parts}", out, want, torch.bfloat16)
        times[f"parts{parts}"] = cuda_ms(call, 50)

    def wrapper():
        return K2.paged_prefill_gqa(q, kp, vp, tables, st, groups=G)
    _hold(f"K2 {tag} wrapper", wrapper(), want, torch.bfloat16)
    times["wrapper"] = cuda_ms(wrapper, 50)
    times["wrapper_device"] = graph_ms(wrapper, 20)
    if parent is not None:
        def old():
            build.check_launch("parent paged_prefill_gqa", parent(
                1, d, bs, q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                tables.data_ptr(), st.data_ptr(), out.data_ptr(), B, KVH,
                S * G, G, mb, 0, 0.0, d ** -0.5, stream()))
        old()
        torch.cuda.synchronize()
        _hold(f"K2 {tag} parent", out, want, torch.bfloat16)
        times["parent"] = cuda_ms(old, 20)
    if sdpa:
        T = start + S
        kg, vg = (p[tables[0]].reshape(-1, KVH, d)[:T].transpose(0, 1)
                  .repeat_interleave(G, 0)[None].contiguous()
                  for p in (kp, vp))
        mask = torch.arange(T, device="cuda")[None, :] \
            <= (start + torch.arange(S, device="cuda"))[:, None]
        qs = q.reshape(1, KVH, S, G, d).permute(0, 1, 3, 2, 4) \
            .reshape(1, KVH * G, S, d)
        times["sdpa"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            qs, kg, vg, attn_mask=mask), 50)
    report("paged_prefill_gqa", tag, tiles, flops, times)


def k8_case(tag, B, H, KVH, d, bs, nb, S, end, T, parent=None, sdpa=False):
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels.sparse_attention import kernel as K8
    rng = np.random.default_rng(SEED + 1)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    start = end - S
    q = torch.randn((B, S, H, d), generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn((B, T, KVH, d), generator=gen,
                        device="cuda").bfloat16() for _ in range(2))
    sel = np.stack([[rng.permutation(start // bs)[:nb]
                     for _ in range(S // bs)] for _ in range(B)])
    ids = torch.from_numpy(sel.astype(np.int32)).cuda()
    qs = torch.full((B,), start, dtype=torch.int32, device="cuda")
    out = torch.empty_like(q)
    flops = 4 * B * S * H * nb * bs * d
    kw = dict(block_size=bs, empty_mean=True)
    want = K8.block_sparse_attention_plain(q, k, v, ids, qs, **kw)
    fn = build.cuda_entry("block_sparse_attention")
    tiles = -(-bs * (H // KVH) // 64) * (S // bs) * B * KVH
    times = {}
    for parts in (1, 2, 4):
        ws = torch.empty(tiles * parts * 64 * (d + 2), device="cuda")

        def call():
            build.check_launch("block_sparse_attention", fn(
                1, d, d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                ids.data_ptr(), qs.data_ptr(), out.data_ptr(), B, S, T, H,
                KVH, bs, nb, 1, 0.0, d ** -0.5, parts, ws.data_ptr(),
                stream()))
        call()
        torch.cuda.synchronize()
        _hold(f"K8 {tag} parts={parts}", out, want, torch.bfloat16)
        times[f"parts{parts}"] = cuda_ms(call, 50)

    def wrapper():
        return K8.block_sparse_attention(q, k, v, ids, qs, **kw)
    _hold(f"K8 {tag} wrapper", wrapper(), want, torch.bfloat16)
    times["wrapper"] = cuda_ms(wrapper, 50)
    times["wrapper_device"] = graph_ms(wrapper, 20)
    if parent is not None:
        def old():
            build.check_launch("parent block_sparse_attention", parent(
                1, d, d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                ids.data_ptr(), qs.data_ptr(), out.data_ptr(), B, S, T, H,
                KVH, bs, nb, 1, 0.0, d ** -0.5, stream()))
        old()
        torch.cuda.synchronize()
        _hold(f"K8 {tag} parent", out, want, torch.bfloat16)
        times["parent"] = cuda_ms(old, 20)
    if sdpa:
        G = H // KVH
        tok = (ids[0].long()[..., None] * bs
               + torch.arange(bs, device="cuda")).reshape(S // bs, nb * bs)
        kg, vg = (x[0][tok].permute(0, 2, 1, 3).repeat_interleave(G, 1)
                  .contiguous() for x in (k, v))
        qb = q[0].reshape(S // bs, bs, H, d).transpose(1, 2).contiguous()
        qpos = start + torch.arange(S, device="cuda").reshape(S // bs, bs)
        mask = (tok[:, None, :] <= qpos[..., None])[:, None]
        times["sdpa"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            qb, kg, vg, attn_mask=mask), 50)
    report("block_sparse_attention", tag, tiles, flops, times)


def parent_libraries(csrc: Path) -> dict:
    """Build the parent's K2 and K8 libraries (into build/parent/) with
    ``-Xptxas -v``; print its K8 body's registers and spills and its SASS
    instruction counts; return the two C entry points."""
    from repro_torch.kernels import build
    out_dir = build.BUILD_DIR / "parent"
    out_dir.mkdir(parents=True, exist_ok=True)
    _I, _P, _F = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
    entries = {}
    for lib, name, argtypes in (
            ("paged_attention", "paged_prefill_gqa",
             [_I] * 3 + [_P] * 6 + [_I] * 6 + [_F, _F, _P]),
            ("block_sparse", "block_sparse_attention",
             [_I] * 3 + [_P] * 6 + [_I] * 8 + [_F, _F, _P])):
        so = out_dir / f"lib{lib}.so"
        proc = subprocess.run(
            [build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(so),
             str(csrc / f"{lib}.cu")], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the parent's {lib}.cu:\n"
                               f"{proc.stderr}")
        if lib == "block_sparse":
            lines = proc.stderr.splitlines()
            for i, line in enumerate(lines):
                if "Compiling entry function" in line \
                        and "block_sparse_kernel" in line:
                    info = " ".join(x.split(":", 1)[-1].strip()
                                    for x in lines[i + 2:i + 4])
                    print(f"[parent.ptxas] {_instance(line)}: {info}",
                          flush=True)
            _sass_counts(so)
        fn = getattr(ctypes.CDLL(str(so)), name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        entries[name] = fn
    return entries


def _instance(mangled: str) -> str:
    dtype = "bf16" if "nv_bfloat16" in mangled else "fp32"
    dims = re.search(r"Li(\d+)ELi(\d+)ELi(\d+)E", mangled)
    return f"block_sparse_kernel<{dtype},{','.join(dims.groups())}>"


def _sass_counts(so: Path) -> None:
    from repro_torch.kernels import build
    tool = Path(build.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    ops, name = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            name = found.group(1)
            ops[name] = []
        elif name and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            op = re.sub(r"/\*[0-9a-f]{4,}\*/\s*", "", line).strip()
            op = re.sub(r"^@!?U?P\w+\s+", "", op)
            if op:
                ops[name].append(op.split()[0].split(".")[0])
    for name, seen in ops.items():
        if "block_sparse_kernel" in name:
            top = collections.Counter(seen).most_common(8)
            print(f"[parent.sass] {_instance(name)}: instructions="
                  f"{len(seen)} " + " ".join(f"{k}={v}" for k, v in top),
                  flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", type=Path, default=None,
                        help="another revision's src/repro_torch/csrc")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("tile_study: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip() or smi.stderr.strip(), flush=True)
    build.build_all(["paged_attention", "block_sparse"])
    for query, insts in (("paged_prefill_gqa_resources",
                          [(d, bs) for d in (64, 128, 256)
                           for bs in (8, 16, 32)]),
                         ("block_sparse_resources",
                          [(64, 64), (128, 128), (192, 256)])):
        for inst in insts:
            regs, spill, smem, ctas, rows = build.resources(query, *inst)
            print(f"[resources] query={query} instance="
                  f"{'x'.join(map(str, inst))} registers={regs} "
                  f"spill_bytes={spill} smem_bytes={smem} "
                  f"ctas_per_sm={ctas} rows_per_cta={rows}", flush=True)
    parent = parent_libraries(args.parent) if args.parent else {}
    # the serve shapes of chip_smoke.py, then grids of 8 to 512 tiles
    k2_case("serve", 1, 4, 8, 128, 16, 768, 256,
            parent=parent.get("paged_prefill_gqa"), sdpa=True)
    k2_case("first-chunk", 1, 4, 8, 128, 16, 0, 256)
    k2_case("chunk-at-3840", 1, 4, 8, 128, 16, 3840, 256)
    k2_case("16-tokens-at-4000", 1, 4, 8, 128, 16, 4000, 16)
    k2_case("8-rows-of-64", 8, 4, 8, 128, 16, 0, 64)
    k8_case("serve", 1, 32, 4, 128, 128, 16, 256, 6144, 6528,
            parent=parent.get("block_sparse_attention"), sdpa=True)
    k8_case("one-query-block", 1, 32, 4, 128, 128, 16, 128, 4096, 4224)
    k8_case("batch-2", 2, 32, 4, 128, 128, 16, 256, 4096, 4224)
    return 0


if __name__ == "__main__":
    sys.exit(main())
