#!/usr/bin/env python3
"""Study of the port's tensor-core tiles and scan on one GPU.

    python3 tile_study.py [--parent DIR] [--only STUDY,...]

The tiles: the bf16 tile of K2, K8 and K9 (``csrc/mma_tile.cuh``), K4's bf16
MLA tile (``csrc/paged_mla.cu``), the fp32 3xTF32 tile of K9 and K8
(``csrc/tf32_tile.cuh``), K10's fp32 3xTF32 logits tile
(``csrc/chunked_ce.cu``), K1's split-KV decode body
(``csrc/paged_attention.cu``), the indexer tensor-core body of K6 and K7
and its decode form, K5's (``csrc/indexer_mma.cuh``), K4's tile at K3's
decode step, and K11's scan (``csrc/mamba_scan.cu``).  The attention
tiles split each tile's key range over ``parts`` CTAs where the tiles
leave CTA slots of the card empty (``repro_torch.kernels.build.
key_split``; K1 and K3 their own decode splits).  This script measures
that choice, the tile sizes and the tiles against their yardsticks:

  resources  every tile's registers, spills, shared memory and CTAs an SM
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
             before the timed loop); with ``--parent``, at the serve
             shapes, this tree's C entry against the parent's at the
             wrapper's parts, device times from CUDA-graph replay taken
             alternately (new, old, old, new, ...; four readings each),
             and the SASS of ``mma_tile``'s attention kernels in both
             trees' K2 and K8 libraries (instructions, identical or not);
  mla     K4 at GLM-5's serve chunk (B 1, S 256 from 768), at the
             verify span of a speculative round (B 8 x S 4 at the serve
             lengths) and at a first chunk (S 256 from 0): the tile built
             with 16 and 32 keys a round and 2 and 3 K/V stages
             (``-DREPRO_MLA_KEYS``, ``-DREPRO_MLA_STAGES``, into
             ``build/study/``), each with 1, 2 and 4 parts, beside the
             wrapper (the default build), SDPA and the plain version's
             bound;
  tf32       K9's fp32 route at Yi-6B's training shape (B 2, S 2048, H 32
             / KVH 4, d 128, causal), at d 64 and 256 (gemma2's heads) and
             with a window of 512: the tile built with 32 and 64 keys a
             round (``-DREPRO_TF32_KEYS``; d 256 takes 32 only), held at
             the fp32 bound, beside SDPA (is_causal) where no window;
  decode     K1 at Yi-6B's decode step (B 8, KVH 4, G 8, d 128, bs 16,
             the serve lengths; each call on another of 8 layers' tables,
             so the K/V come from device memory), bf16 and fp32: the C
             entry point with the key range in 1, 2, 4, 8, 12 and 16 parts
             and the wrapper (its own parts), device times from CUDA-graph
             replay, each held against the plain version; SDPA's device
             time on the same step (the KV gathered once); the wrapper's
             host microseconds a call (``chip_smoke.host_us``);
  ce         K10's fp32 route at Yi-6B's training shape (Tk 4096, D 4096,
             V 64000): the tile built with warp tiles of 64 x 32 and 32 x 64
             (tokens x ids, ``-DREPRO_CE_WARP_M``) and 3 and 2 stages
             (``-DREPRO_CE_STAGES``), each held at 1e-5 relative against
             the plain version and timed (CUDA events);
  sparse32   K8's fp32 route (the 3xTF32 tile) at the block selector's
             training chunk (S 256 from 3840 against 16 blocks of 128 keys,
             H 32 / KVH 4, d 128): the tile built with 32 and 64 keys a
             round (``-DREPRO_TF32_KEYS``), each with the key range in 1, 2
             and 4 parts, device times from CUDA-graph replay, held at the
             fp32 bound, beside the wrapper (its own parts) and SDPA;
  flash_bf16 K9's bf16 route (the tensor-core tile) at the RL loop
             backend's re-forward (B 1, S 240, H 32 / KVH 4, d 128,
             causal), at S 128 and 512, B 4 and d 256: the tile with the
             keys in 1, 2 and 4 parts, and the wrapper (its own parts),
             device times from CUDA-graph replay, held at the bf16 bound,
             beside SDPA's device time (is_causal, KV heads repeated once
             before the timed loop) and the wrapper's host microseconds a
             call (with ``--parent``, taken alternately against the
             parent's wrapper, four readings each);
  indexer    K6's bf16 route (the tensor-core body) at the DSA serve span
             (S 256 ending at 6143 of a view of 6432 positions, blocks of
             16) at Yi-6B's Hi 16 / Di 64: the body built with 1, 2 and 4
             tokens a warp (``-DREPRO_IDX_TOKENS``) and chunks of 2, 4 and
             8 rounds of 64 keys a CTA (``-DREPRO_IDX_ROUNDS``); and at
             zamba2's Hi 8 / Di 64 (one n-tile of heads) with 2, 4 and 8
             tokens a warp and 2, 4 and 8 rounds;
             device times from CUDA-graph replay, held at the bf16 bound,
             beside the wrapper's device and host time;
  lightning  K7 on that body at Hi 16 / Di 64: the DSA training chunk
             (fp32 by 3xTF32, S 256 against 4096 keys) with the body built
             at tokens a warp x rounds a CTA x keys a round
             (``-DREPRO_IDX32_TOKENS``, ``_ROUNDS``, ``_KEYS``), and the
             block selector's last serve span of the 6144-token prompt
             (bf16, S 256 against its 6528-position view, 8 layers' keys)
             with ``-DREPRO_IDX_TOKENS`` / ``_ROUNDS``; device times from
             CUDA-graph replay, each held at its dtype's bound, beside the
             wrapper's times and host microseconds a call;
  scan       K11's model form at falcon-mamba's serve prefill (B 8, S
             1024, bf16), training shape (B 2 and 4, S 2048, fp32) and
             decode step (B 8, S 1): the scan built with 4, 2 and 8 time
             steps a round (``-DREPRO_SCAN_STEPS``), each at every time
             split 1..16 the shape allows, held at the fp32 bound against
             the plain version, beside the wrapper (its parts) and its host
             microseconds a call, and the SFU floor;
  mla_decode K3 (bf16) at GLM-5's decode step (B 8, H 64, bs 16, the serve
             lengths; each call on another of 8 layers' tables, so the
             latent comes from device memory): the C entry point with each
             row's key rounds in 1, 2, 4, 8 and 16 parts, the tile built
             with 32 and 16 keys a round (``-DREPRO_MLA_KEYS``), device
             times from CUDA-graph replay, each held at the bf16 bound;
             the wrapper (its own parts: time, device time, host
             microseconds a call) and SDPA's device time over the latent
             gathered to the 64 heads;
  indexer_decode  K5 (bf16) at the DSA serve phase's decode step (B 8 at
             the DSA mix's lengths + 16, a view of 6432 positions, blocks
             of 16, 8 layers' tables) at Yi-6B's (16 x 64), GLM-5's (32
             x 128) and zamba2's (8 x 64) indexer shapes: the C entry
             point's device time from
             CUDA-graph replay, held at the bf16 bound with the dead blocks
             equal, beside the wrapper's time, device time and host
             microseconds a call;
  ssd_heads  K11's head-shared chunked route (``csrc/ssd_scan.cuh``) at
             zamba2's prefill span (B 1, S 256, bf16) and training shape
             (B 2, S 2048, fp32): every divisor of 80 up to 8 heads a chunk
             CTA, device times from CUDA-graph replay in turns against the
             wrapper's choice, each held at the fp32 bound, with each of
             the three kernels' device microseconds;
  dsa_flips  zamba2 + DSA at 12 layers, B 1, S 2560 (the train parity's
             shape), seeds 0-3: each top-k selection of the forward on the
             kernel route, and with K11's head-shared form on the parent's
             thread-a-channel body, against the plain route's: differing
             indices, near-ties (``chip_smoke._TopkAlign``'s rule), the
             largest score gap;
  parent     with ``--parent DIR``, another revision's
             ``src/repro_torch/csrc`` with its ``src/repro_torch/kernels``
             beside it (for example ``git archive <commit> src/repro_torch``,
             unpacked): its K2, K8 (both dtypes), K4, K9, K1, K10, K6, K7,
             K11, K3 and K5 at the same shapes, called through the C
             interface that revision had (its ``kernels/build.py``; K2, K4
             and K8 with one part; K1, K3, K5 and K11 through that
             revision's own wrappers, so their host work is measured as it
             was), and its
             K4 and K9 bodies' registers and spills (``nvcc -Xptxas -v``).

``--only`` runs (and builds for) the named studies alone (``--only
flash_bf16,indexer --parent DIR``: this PR's two redesigns beside the
parent's bodies, ~4 min).  It prints the
card's name and power limit first.  It needs a CUDA device
and exits non-zero without one.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

from chip_smoke import _hold, cuda_ms, graph_ms, host_us

ROOT = Path(__file__).resolve().parent
SEED = 0


def stream() -> int:
    import torch
    return torch.cuda.current_stream().cuda_stream


def report(kernel, tag, tiles, flops, times) -> None:
    print(f"[split] kernel={kernel} case={tag} tiles={tiles} " + " ".join(
        f"{k}_ms={v:.5f} {k}_tflops={flops / v / 1e9:.1f}"
        for k, v in times.items()), flush=True)


def alternate(new, old, measure=lambda fn: graph_ms(fn, 50),
              rounds: int = 4) -> dict:
    """``measure`` of ``new`` and of ``old`` (by default device milliseconds
    a call from CUDA-graph replay), taken in the order new, old, old, new,
    new, old, ... so that neither gains from the card or the host warming:
    {"new": [...], "old": [...]}, ``rounds`` readings each."""
    got = {"new": [], "old": []}
    for i in range(rounds):
        for name in (("new", "old") if i % 2 == 0 else ("old", "new")):
            got[name].append(measure(new if name == "new" else old))
    return got


def report_alternate(kernel, tag, parts, got, unit="ms") -> None:
    print(f"[alternate] kernel={kernel} case={tag} parts={parts} " + " ".join(
        f"{k}_{unit}={','.join(f'{x:.5f}' for x in v)}"
        for k, v in got.items()), flush=True)


def _sass_functions(so: Path) -> dict:
    """kernel name -> its SASS instructions (addresses and encodings
    dropped) in the library ``so``; the anonymous namespace's per-build
    hash is taken out of each name, so two builds' names match."""
    import shutil
    from repro_torch.kernels import build
    tool = shutil.which("cuobjdump") or str(Path(build.nvcc()).parent
                                            / "cuobjdump")
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            name = re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]+",
                          "", found.group(1))
            out[name] = []
        elif name is not None and "/*" in line:
            ins = re.sub(r"/\*[0-9a-f]{4,}\*/", "", line.split(";")[0])
            if ins.strip() and not ins.strip().startswith("/*"):
                out[name].append(ins.strip())
    return out


def sass_against_parent() -> None:
    """The SASS of ``mma_tile``'s attention kernels in this tree's K2 and
    K8 libraries against the parent's (``build/parent/``): instructions
    each and whether they are the same."""
    from repro_torch.kernels import build
    for lib in ("paged_attention", "block_sparse"):
        new = _sass_functions(build.library_path(lib))
        old = _sass_functions(build.BUILD_DIR / "parent" / f"lib{lib}.so")
        for name, ins in sorted(new.items()):
            if "mma_tile" not in name or "attention_kernel" not in name:
                continue
            was = old.get(name, [])
            label = "mma_tile::attention_kernel<{},{}>".format(
                ",".join(re.findall(r"Li(\d+)E", name)),
                "SelectedBlocks" if "SelectedBlocks" in name
                else "PagedSpan")
            print(f"[sass] library={lib} kernel={label} "
                  f"instructions={len(ins)} parent_instructions={len(was)} "
                  f"identical={ins == was}", flush=True)


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
                S * G, G, mb, 0, 0.0, d ** -0.5, 1, None, stream()))
        old()
        torch.cuda.synchronize()
        _hold(f"K2 {tag} parent", out, want, torch.bfloat16)
        times["parent"] = cuda_ms(old, 20)
        # this tree's entry against the parent's at the wrapper's parts
        parts, ws = build.key_split("paged_prefill_gqa_resources", (d, bs),
                                    S * G, KVH * B, d, q.device)

        def entry(f):
            return lambda: build.check_launch("paged_prefill_gqa", f(
                1, d, bs, q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                tables.data_ptr(), st.data_ptr(), out.data_ptr(), B, KVH,
                S * G, G, mb, 0, 0.0, d ** -0.5, parts,
                None if ws is None else ws.data_ptr(), stream()))
        report_alternate("paged_prefill_gqa", tag, parts,
                         alternate(entry(fn), entry(parent)))
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
                KVH, bs, nb, 1, 0.0, d ** -0.5, 1, None, stream()))
        old()
        torch.cuda.synchronize()
        _hold(f"K8 {tag} parent", out, want, torch.bfloat16)
        times["parent"] = cuda_ms(old, 20)
        parts, ws = build.key_split("block_sparse_resources", (1, d, d),
                                    bs * (H // KVH), (S // bs) * B * KVH, d,
                                    q.device)

        def entry(f):
            return lambda: build.check_launch("block_sparse_attention", f(
                1, d, d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                ids.data_ptr(), qs.data_ptr(), out.data_ptr(), B, S, T, H,
                KVH, bs, nb, 1, 0.0, d ** -0.5, parts,
                None if ws is None else ws.data_ptr(), stream()))
        report_alternate("block_sparse_attention", tag, parts,
                         alternate(entry(fn), entry(parent)))
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


def _nvcc(src: Path, out: Path, defines=(), verbose=False):
    """Start nvcc on ``src`` (the repo's flags, ``-D`` ``defines``,
    ``-Xptxas -v`` when ``verbose``) into ``out``; returns the process."""
    from repro_torch.kernels import build
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [build.nvcc(), *build.NVCC_FLAGS, *(f"-D{d}" for d in defines),
           *(["-Xptxas", "-v"] if verbose else []), "-o", str(out), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _entry(so: Path, name: str, argtypes):
    fn = getattr(ctypes.CDLL(str(so)), name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


# the tile sizes studied: (keys a round, K/V stages) of K4's tile, keys a
# round of K9's and K8's fp32 tile; the first of each is the default build's
MLA_VARIANTS = ((32, 2), (32, 3), (16, 2), (16, 3))
TF32_VARIANTS = (32, 64)
# K10's fp32 tile: (tokens a warp, stages)
CE_VARIANTS = ((64, 3), (64, 2), (32, 3), (32, 2))
# K6's tensor-core body: (tokens a warp, rounds of 64 keys a CTA)
IDX_VARIANTS = ((4, 4), (4, 2), (4, 8), (2, 4), (2, 8), (1, 8))
# ... at 8 heads
IDX8_VARIANTS = ((4, 4), (4, 2), (4, 8), (8, 4), (8, 2), (2, 4))
# K7's fp32 route on that body: (tokens a warp, rounds a CTA, keys a round)
IDX32_VARIANTS = ((2, 8, 64), (2, 4, 64), (1, 8, 64), (1, 16, 64),
                  (4, 8, 32), (4, 16, 32), (2, 16, 32))
# K11's time steps a round
SCAN_VARIANTS = (4, 2, 8)
# K3's decode: keys a round of the MLA tile (-DREPRO_MLA_KEYS)
MLAD_VARIANTS = (32, 16)


# the studies each variant (by its tag's prefix) and each parent library
# serve, so that ``--only`` builds no more than it runs
PREFIX_STUDY = {"mla_": "mla", "tf32_": "tf32", "sparse32_": "sparse32",
                "idx_": "indexer", "idx8_": "indexer", "li_": "lightning",
                "li32_": "lightning",
                "scan_": "scan", "ce_": "ce", "mlad_": "mla_decode"}
LIBRARY_STUDIES = {"paged_attention": ("split", "decode"),
                   "block_sparse": ("split", "sparse32"),
                   "paged_mla": ("mla", "mla_decode"),
                   "flash_attention": ("tf32", "flash_bf16"),
                   "chunked_ce": ("ce",),
                   "paged_indexer": ("indexer", "indexer_decode"),
                   "lightning_indexer": ("lightning",),
                   "mamba_scan": ("scan",)}


def variant_libraries(run=lambda study: True) -> dict:
    """Build K4's, K9's, K10's, K8's, K6's, K7's and K11's libraries at
    every other tile size that a study ``run`` takes (into build/study/,
    all nvcc processes at once); returns name -> the C entry point
    (``mla_k{keys}_s{stages}``, ``tf32_k{keys}``, ``ce_m{warp_m}_s{stages}``,
    ``sparse32_k{keys}``, ``idx_t{tokens}_r{rounds}``,
    ``idx8_t{tokens}_r{rounds}`` (K6 at 8 heads),
    ``li_t{tokens}_r{rounds}`` (K7 bf16), ``li32_t{tokens}_r{rounds}_k{keys}``
    (K7 fp32), ``scan_s{steps}``, ``mlad_k{keys}`` (K3))."""
    from repro_torch.kernels import build
    out_dir = build.BUILD_DIR / "study"
    jobs = {}

    def add(tag, lib, name, defines):
        study = next(v for k, v in PREFIX_STUDY.items() if tag.startswith(k))
        if run(study):
            jobs[tag] = (lib, name, _nvcc(build.CSRC / f"{lib}.cu",
                                          out_dir / tag / f"lib{lib}.so",
                                          defines))
    for keys, stages in MLA_VARIANTS[1:]:
        add(f"mla_k{keys}_s{stages}", "paged_mla", "paged_prefill_mla",
            (f"REPRO_MLA_KEYS={keys}", f"REPRO_MLA_STAGES={stages}"))
    for keys in TF32_VARIANTS[1:]:
        add(f"tf32_k{keys}", "flash_attention", "flash_attention",
            (f"REPRO_TF32_KEYS={keys}",))
        add(f"sparse32_k{keys}", "block_sparse", "block_sparse_attention",
            (f"REPRO_TF32_KEYS={keys}",))
    for tokens, rounds in IDX_VARIANTS[1:]:
        knobs = (f"REPRO_IDX_TOKENS={tokens}", f"REPRO_IDX_ROUNDS={rounds}")
        add(f"idx_t{tokens}_r{rounds}", "paged_indexer",
            "paged_prefill_indexer", knobs)
        add(f"li_t{tokens}_r{rounds}", "lightning_indexer",
            "lightning_indexer", knobs)
    for tokens, rounds in IDX8_VARIANTS[1:]:
        add(f"idx8_t{tokens}_r{rounds}", "paged_indexer",
            "paged_prefill_indexer", (f"REPRO_IDX_TOKENS={tokens}",
                                      f"REPRO_IDX_ROUNDS={rounds}"))
    for tokens, rounds, keys in IDX32_VARIANTS[1:]:
        add(f"li32_t{tokens}_r{rounds}_k{keys}", "lightning_indexer",
            "lightning_indexer",
            (f"REPRO_IDX32_TOKENS={tokens}", f"REPRO_IDX32_ROUNDS={rounds}",
             f"REPRO_IDX32_KEYS={keys}"))
    for steps in SCAN_VARIANTS[1:]:
        add(f"scan_s{steps}", "mamba_scan", "mamba_scan_model",
            (f"REPRO_SCAN_STEPS={steps}",))
    for keys in MLAD_VARIANTS[1:]:
        add(f"mlad_k{keys}", "paged_mla", "paged_decode_mla",
            (f"REPRO_MLA_KEYS={keys}",))

    for warp_m, stages in CE_VARIANTS[1:]:
        add(f"ce_m{warp_m}_s{stages}", "chunked_ce", "chunked_ce",
            (f"REPRO_CE_WARP_M={warp_m}", f"REPRO_CE_STAGES={stages}"))
    entries = {}
    for tag, (lib, name, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {tag}:\n{err}")
        entries[tag] = _entry(out_dir / tag / f"lib{lib}.so", name,
                              build.ENTRIES[name][1])
    return entries


def parent_libraries(csrc: Path, run=lambda study: True) -> dict:
    """Build the parent's K2, K8, K4, K9, K1, K10, K6, K7, K11, K3 and K5
    libraries (into build/parent/) with ``-Xptxas -v``; print its K4 and
    K9 bodies' registers and spills; return the C entry points (with the
    arguments of that revision's ``kernels/build.py`` beside ``csrc``) and,
    for K1, K3, K5 and K11, the parent's wrappers (its
    ``kernels/paged_attention/kernel.py`` and
    ``kernels/mamba_scan/kernel.py``) around its entry points, and K9's
    (``flash_attention_wrapper``) beside its raw entry."""
    from repro_torch.kernels import build
    out_dir = build.BUILD_DIR / "parent"
    libs = {"paged_attention": ["paged_prefill_gqa", "paged_decode_gqa"],
            "block_sparse": ["block_sparse_attention"],
            "paged_mla": ["paged_prefill_mla", "paged_decode_mla"],
            "flash_attention": ["flash_attention"],
            "chunked_ce": ["chunked_ce"],
            "paged_indexer": ["paged_prefill_indexer",
                              "paged_indexer_scores"],
            "lightning_indexer": ["lightning_indexer"],
            "mamba_scan": ["mamba_scan_model"]}
    libs = {lib: names for lib, names in libs.items()
            if any(run(st) for st in LIBRARY_STUDIES[lib])}
    entries_of = _module(csrc.parent / "kernels" / "build.py",
                         "parent_build").ENTRIES
    procs = {lib: _nvcc(csrc / f"{lib}.cu", out_dir / f"lib{lib}.so",
                        verbose=True) for lib in libs}
    entries = {}
    for lib, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the parent's {lib}.cu:\n"
                               f"{err}")
        lines = err.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and any(
                    m in line for m in ("paged_mla_kernel", "DenseKV")):
                info = " ".join(x.split(":", 1)[-1].strip()
                                for x in lines[i + 2:i + 4])
                print(f"[parent.ptxas] {lib} {_instance(line)}: {info}",
                      flush=True)
        for name in libs[lib]:
            entries[name] = _entry(out_dir / f"lib{lib}.so", name,
                                   entries_of[name][1])
    kernels = csrc.parent / "kernels"
    if "flash_attention" in entries:   # K9's wrapper beside its raw entry
        entries["flash_attention_wrapper"] = _parent_wrapper(
            kernels / "flash_attention" / "kernel.py",
            entries["flash_attention"], "flash_attention")
    for name, path, wrapper in (
            ("paged_decode_gqa", "paged_attention", "paged_decode_gqa"),
            ("paged_decode_mla", "paged_attention", "paged_decode_mla"),
            ("paged_indexer_scores", "paged_attention",
             "paged_indexer_scores_kernel"),
            ("mamba_scan_model", "mamba_scan", "mamba_scan_model")):
        if name in entries:
            entries[name] = _parent_wrapper(kernels / path / "kernel.py",
                                            entries[name], wrapper)
    return entries


def _module(path: Path, name: str):
    """The module of another revision's file ``path``, loaded as ``name``."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _parent_wrapper(path: Path, entry, wrapper: str):
    """The other revision's wrapper ``wrapper``, its own Python (``path``)
    around its own C entry point: its host work as it was."""
    module = _module(path, f"parent_{wrapper}")
    module.cuda_entry = lambda name: entry
    return getattr(module, wrapper)


def _instance(mangled: str) -> str:
    """A short name for a parent SIMT body's mangled instantiation: its
    kernel, element type and template integers."""
    kernel = "paged_mla_kernel" if "paged_mla_kernel" in mangled \
        else "gqa_tile_kernel"
    dtype = "bf16" if "nv_bfloat16" in mangled else "fp32"
    dims = re.findall(r"Li(\d+)E", mangled)
    return f"{kernel}<{dtype},{','.join(dims)}>"


def k4_case(tag, B, H, bs, starts, S, variants, parent=None, sdpa=False):
    """K4 (bf16) at one shape: every tile-size variant with 1, 2 and 4
    parts, the wrapper (the default build, its own parts), SDPA and the
    parent."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import prefill as K4
    rng = np.random.default_rng(SEED + 2)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    L, R, scale = 512, 64, 192 ** -0.5
    nbk = 4096
    c = torch.randn((nbk + 1, bs, L), generator=gen, device="cuda").bfloat16()
    kr = torch.randn((nbk + 1, bs, R), generator=gen,
                     device="cuda").bfloat16()
    mb = (max(starts) + S) // bs + 1
    t = np.full((B, mb), nbk, np.int32)
    perm, at = rng.permutation(nbk), 0
    for b, st in enumerate(starts):
        live = (st + S - 1) // bs + 1
        t[b, :live] = perm[at:at + live]
        at += live
    tables = torch.from_numpy(t).cuda()
    st = torch.tensor(starts, dtype=torch.int32, device="cuda")
    q_lat = torch.randn((B, S * H, L), generator=gen, device="cuda")
    q_rope = torch.randn((B, S * H, R), generator=gen,
                         device="cuda").bfloat16()
    out = torch.empty_like(q_lat)
    flops = H * sum(s0 + i + 1 for s0 in starts for i in range(S)) \
        * (2 * (L + R) + 2 * L)
    want = K4.paged_prefill_mla_plain(q_lat, q_rope, c, kr, tables, st,
                                      heads=H, scale=scale)
    tiles = -(-S * H // 64) * B
    times = {}
    for name, fn in variants.items():
        for parts in (1, 2, 4):
            ws = torch.empty(tiles * parts * 64 * (L + 2), device="cuda")

            def call():
                build.check_launch("paged_prefill_mla", fn(
                    1, L, R, bs, q_lat.data_ptr(), q_rope.data_ptr(),
                    c.data_ptr(), kr.data_ptr(), tables.data_ptr(),
                    st.data_ptr(), out.data_ptr(), B, S * H, H, mb, scale,
                    parts, ws.data_ptr(), stream()))
            call()
            torch.cuda.synchronize()
            _hold(f"K4 {tag} {name} parts={parts}", out, want,
                  torch.bfloat16)
            times[f"{name}_p{parts}"] = cuda_ms(call, 30)

    def wrapper():
        return K4.paged_prefill_mla(q_lat, q_rope, c, kr, tables, st,
                                    heads=H, scale=scale)
    _hold(f"K4 {tag} wrapper", wrapper(), want, torch.bfloat16)
    times["wrapper"] = cuda_ms(wrapper, 30)
    times["wrapper_device"] = graph_ms(wrapper, 10)
    if parent is not None:
        def old():
            build.check_launch("parent paged_prefill_mla", parent(
                1, L, R, bs, q_lat.data_ptr(), q_rope.data_ptr(),
                c.data_ptr(), kr.data_ptr(), tables.data_ptr(),
                st.data_ptr(), out.data_ptr(), B, S * H, H, mb, scale, 1,
                None, stream()))
        old()
        torch.cuda.synchronize()
        _hold(f"K4 {tag} parent", out, want, torch.bfloat16)
        times["parent"] = cuda_ms(old, 10)
    if sdpa:
        T = max(starts) + S
        cv = c[tables].reshape(B, -1, L)[:, :T]
        k = torch.cat([cv, kr[tables].reshape(B, -1, R)[:, :T]], dim=-1)
        kh = k[:, None].expand(B, H, T, L + R).contiguous()
        vh = cv[:, None].expand(B, H, T, L).contiguous()
        qpos = st[:, None].long() + torch.arange(S, device="cuda")
        mask = (torch.arange(T, device="cuda")[None, None]
                <= qpos[..., None])[:, None]
        qs = torch.cat([q_lat.bfloat16(), q_rope], -1) \
            .reshape(B, S, H, L + R).transpose(1, 2)
        times["sdpa"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            qs, kh, vh, attn_mask=mask, scale=scale), 30)
    report("paged_prefill_mla", tag, tiles, flops, times)


def k9_case(tag, B, S, H, KVH, d, variants, parent=None, sdpa=False,
            **kw):
    """K9 (fp32) at one shape: every tile-size variant, the wrapper (the
    default build), SDPA where the mask is the plain causal one, and the
    parent; each held at the fp32 bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as K9
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    q = torch.randn((B, S, H, d), generator=gen, device="cuda")
    k, v = (torch.randn((B, S, KVH, d), generator=gen, device="cuda")
            for _ in range(2))
    out = torch.empty_like(q)
    window = kw.get("window", 0)
    keys = sum(min(i + 1, window) if window else i + 1 for i in range(S))
    flops = 4 * B * H * keys * d
    want = K9.reference(q, k, v, **kw)
    times = {}
    entries = dict(variants)
    if parent is not None:
        entries["parent"] = parent
    for name, fn in entries.items():
        if d > 128 and name.startswith("tf32_k") and name != "tf32_k32":
            continue                      # d 256 takes one tile size only

        def call():
            build.check_launch("flash_attention", fn(
                0, d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), B, S, S, H, KVH, 1, window, 0, 0.0,
                d ** -0.5, *_k9_parts(fn, 1), stream()))
        call()
        torch.cuda.synchronize()
        _hold(f"K9 {tag} {name}", out, want, torch.float32)
        times[name] = cuda_ms(call, 10)
    _hold(f"K9 {tag} wrapper", K9.flash_attention(q, k, v, **kw), want,
          torch.float32)
    times["wrapper_device"] = graph_ms(
        lambda: K9.flash_attention(q, k, v, **kw), 5)
    if sdpa:
        qs = q.transpose(1, 2).contiguous()
        ks, vs = (x.repeat_interleave(H // KVH, 2).transpose(1, 2)
                  .contiguous() for x in (k, v))
        times["sdpa"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True), 10)
    report("flash_attention", tag, -(-S * (H // KVH) // 64) * KVH * B,
           flops, times)


def _k9_parts(fn, parts, ws=None) -> tuple:
    """The key-range split arguments of K9's C entry point (parts,
    workspace) where it takes them: revisions before the bf16 tile's took
    none (17 arguments)."""
    if len(fn.argtypes) == 17:
        if parts != 1:
            raise ValueError("this K9 entry point takes no key split")
        return ()
    return parts, None if ws is None else ws.data_ptr()


def k9_bf16_case(tag, B, S, H, KVH, d, parent=None, parent_wrapper=None):
    """K9's bf16 route at one causal shape (see ``flash_bf16``): the C
    entry at 1, 2 and 4 parts, the wrapper, SDPA and the parent's entry;
    the wrapper's host microseconds a call alternately against the parent's
    wrapper (its own Python around its own entry)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as K9
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    bf = torch.bfloat16
    q = torch.randn((B, S, H, d), generator=gen, device="cuda").to(bf)
    k, v = (torch.randn((B, S, KVH, d), generator=gen, device="cuda").to(bf)
            for _ in range(2))
    out = torch.empty_like(q)
    want = K9.reference(q, k, v)
    tiles = -(-S * (H // KVH) // 64) * KVH * B
    entries = {"tile": build.cuda_entry("flash_attention")}
    if parent is not None:
        entries["parent"] = parent
    times = {}
    for name, fn in entries.items():
        for parts in ((1,) if name == "parent" else (1, 2, 4)):
            ws = torch.empty(tiles * parts * 64 * (d + 2), device="cuda")

            def call():
                build.check_launch("flash_attention", fn(
                    1, d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    out.data_ptr(), B, S, S, H, KVH, 1, 0, 0, 0.0,
                    d ** -0.5, *_k9_parts(fn, parts, ws), stream()))
            call()
            torch.cuda.synchronize()
            _hold(f"K9 bf16 {tag} {name} parts={parts}", out, want, bf)
            times[f"{name}_p{parts}"] = graph_ms(call, 20)

    def wrapper():
        return K9.flash_attention(q, k, v)
    _hold(f"K9 bf16 {tag} wrapper", wrapper(), want, bf)
    times["wrapper"] = cuda_ms(wrapper, 20)
    times["wrapper_device"] = graph_ms(wrapper, 20)
    if parent_wrapper is not None:
        report_alternate("flash_attention", tag, "wrapper's", alternate(
            wrapper, lambda: parent_wrapper(q, k, v), host_us), unit="host_us")
    qs = q.transpose(1, 2).contiguous()
    ks, vs = (x.repeat_interleave(H // KVH, 2).transpose(1, 2).contiguous()
              for x in (k, v))
    times["sdpa_device"] = graph_ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True), 20)
    parts = K9.bf16_parts(d, S * (H // KVH), B * KVH, q.device)
    flops = 4 * B * H * d * S * (S + 1) / 2
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    bound = max(flops / 989e12, nbytes / 3.35e12) * 1e3
    print(f"[flash_bf16] kernel=flash_attention case={tag} B={B} S={S} H={H} "
          f"KVH={KVH} d={d} tiles={tiles} wrapper_parts={parts} "
          f"bound_ms={bound:.5f} wrapper_host_us={host_us(wrapper):.2f} "
          + " ".join(f"{k_}_ms={v_:.5f}" for k_, v_ in times.items()),
          flush=True)


SERVE_LENS = (1040, 48, 793, 166, 528, 80, 916, 316)   # chip_smoke's decode
DSA_LENS = (6160, 48, 3016, 166, 4112, 80, 2516, 316)  # ... of the DSA mix


def _decode_tables(rng, lens, bs, mb, nbk, layers):
    """Each of ``layers`` layers' tables over one layer-major pool of
    ``layers`` x (nbk + 1) blocks: row b's live blocks disjoint and
    shuffled, the rest the trash block (each layer's last)."""
    import numpy as np
    import torch
    t = np.full((len(lens), mb), nbk, np.int32)
    perm, at = rng.permutation(nbk), 0
    for b, n in enumerate(lens):
        live = int(n) // bs + 1
        t[b, :live] = perm[at:at + live]
        at += live
    return [torch.from_numpy(t + g * (nbk + 1)).cuda() for g in range(layers)]


def k1_case(dtype_name, parent=None):
    """K1 at Yi-6B's decode step (see the module's ``decode``); ``parent``
    the other revision's K1 wrapper."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import kernel as K1
    dtype = getattr(torch, dtype_name)
    B, KVH, G, d, bs, layers, nbk = 8, 4, 8, 128, 16, 8, 2048
    lens = np.asarray(SERVE_LENS, np.int32)
    mb = 82
    rng = np.random.default_rng(SEED + 4)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    kp, vp = (torch.randn((layers * (nbk + 1), bs, KVH, d), generator=gen,
                          device="cuda").to(dtype) for _ in range(2))
    tables = _decode_tables(rng, lens, bs, mb, nbk, layers)
    sl = torch.from_numpy(lens).cuda()
    q = torch.randn((B, KVH, G, d), generator=gen, device="cuda").to(dtype)
    out = torch.empty_like(q)
    want = [K1.paged_decode_gqa_plain(q, kp, vp, tb, sl) for tb in tables]
    it = iter(range(10 ** 9))
    times = {}
    fn = build.cuda_entry("paged_decode_gqa")
    code = build.DTYPE_CODE[dtype]
    for parts in (1, 2, 4, 8, 12, 16):
        ws = torch.empty(K1.decode_workspace(B, KVH, G, d, parts),
                         device="cuda")

        def call():
            g = next(it) % layers
            build.check_launch("paged_decode_gqa", fn(
                code, d, bs, q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                tables[g].data_ptr(), sl.data_ptr(), out.data_ptr(), B, KVH,
                G, mb, 0, 0.0, d ** -0.5, parts, ws.data_ptr(), stream()))
            return g
        g = call()
        torch.cuda.synchronize()
        _hold(f"K1 {dtype_name} parts={parts}", out, want[g], dtype)
        times[f"parts{parts}"] = graph_ms(call, 64)

    def wrapper():
        return K1.paged_decode_gqa(q, kp, vp, tables[next(it) % layers], sl)
    _hold(f"K1 {dtype_name} wrapper",
          K1.paged_decode_gqa(q, kp, vp, tables[0], sl), want[0], dtype)
    times["wrapper"] = cuda_ms(wrapper, 64)
    times["wrapper_device"] = graph_ms(wrapper, 64)
    host = {"wrapper_host_us": host_us(wrapper)}
    if parent is not None:
        def old_wrapper():
            return parent(q, kp, vp, tables[next(it) % layers], sl)
        it = iter(range(10 ** 9))         # old_wrapper's first: layer 0
        _hold(f"K1 {dtype_name} parent", old_wrapper(), want[0], dtype)
        times["parent_device"] = graph_ms(old_wrapper, 64)
        host["parent_host_us"] = host_us(old_wrapper)
    if dtype == torch.bfloat16:
        T = int(lens.max()) + 1
        views = [tuple(p[tb.long()].reshape(B, -1, KVH, d)[:, :T]
                       .transpose(1, 2).repeat_interleave(G, 1).contiguous()
                       for p in (kp, vp)) for tb in tables]
        mask = (torch.arange(T, device="cuda")[None, :]
                <= sl[:, None].long())[:, None, None, :]
        qs = q.reshape(B, KVH * G, 1, d)
        times["sdpa_device"] = graph_ms(
            lambda: F.scaled_dot_product_attention(
                qs, *views[next(it) % layers], attn_mask=mask), 64)
    item = q.element_size()
    nbytes = int((lens + 1).sum()) * KVH * d * 2 * item \
        + 2 * q.numel() * item + B * mb * 4 + B * 4
    print(f"[decode] kernel=paged_decode_gqa dtype={dtype_name} "
          f"bound_ms={nbytes / 3.35e12 * 1e3:.5f} " + " ".join(
              f"{k}_ms={v:.5f} {k}_gb_per_s={nbytes / v / 1e6:.0f}"
              for k, v in times.items()) + " " + " ".join(
              f"{k}={v:.2f}" for k, v in host.items()), flush=True)


def k10_case(variants, parent=None):
    """K10's fp32 route at Yi-6B's training shape (see ``ce``)."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.chunked_ce import kernel as K10
    Tk, D, V = 4096, 4096, 64000
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    h = torch.randn(Tk, D, generator=gen, device="cuda")
    w = torch.randn(D, V, generator=gen, device="cuda") * D ** -0.5
    t = torch.randint(0, V, (Tk,), generator=gen, device="cuda",
                      dtype=torch.int32)
    m = torch.ones(Tk, device="cuda")
    want = float(K10.reference(h, w, t, m)[0])
    n_tt, n_vt = -(-Tk // 128), -(-V // 128)
    part = torch.empty(3 * n_vt * Tk, device="cuda")
    sums = torch.empty((2, n_tt), device="cuda")
    entries = dict(variants)
    if parent is not None:
        entries["parent"] = parent
    times = {}
    for name, fn in entries.items():
        def call():
            build.check_launch("chunked_ce", fn(
                0, h.data_ptr(), w.data_ptr(), t.data_ptr(), m.data_ptr(),
                part.data_ptr(), sums[0].data_ptr(), sums[1].data_ptr(), Tk,
                D, V, 0.0, stream()))
        call()
        got = float(sums[0].sum())
        if not abs(got - want) <= 1e-5 * abs(want):
            raise AssertionError(f"K10 {name}: {got} vs plain {want}")
        times[name] = cuda_ms(call, 3)
    flops = 2 * Tk * D * V
    print(f"[ce] kernel=chunked_ce Tk={Tk} D={D} V={V} "
          f"bound_3xtf32_ms={3 * flops / 494.7e12 * 1e3:.3f} "
          f"bound_fp32_cores_ms={flops / 67e12 * 1e3:.3f} " + " ".join(
              f"{k}_ms={v:.3f} {k}_tflops={flops / v / 1e9:.1f}"
              for k, v in times.items()), flush=True)


def k8_fp32_case(variants, parent=None):
    """K8's fp32 route at the block selector's training chunk (see
    ``sparse32``)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels.sparse_attention import kernel as K8
    B, S, H, KVH, d, bs, nb, T = 1, 256, 32, 4, 128, 128, 16, 4096
    start = T - S
    rng = np.random.default_rng(SEED + 6)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    q = torch.randn((B, S, H, d), generator=gen, device="cuda")
    k, v = (torch.randn((B, T, KVH, d), generator=gen, device="cuda")
            for _ in range(2))
    sel = np.stack([rng.permutation(start // bs)[:nb] for _ in range(S // bs)])
    ids = torch.from_numpy(sel[None].astype(np.int32)).cuda()
    qs = torch.full((B,), start, dtype=torch.int32, device="cuda")
    out = torch.empty_like(q)
    flops = 4 * B * S * H * nb * bs * d
    kw = dict(block_size=bs, empty_mean=True)
    want = K8.block_sparse_attention_plain(q, k, v, ids, qs, **kw)
    tiles = -(-bs * (H // KVH) // 64) * (S // bs) * B * KVH
    entries = dict(variants)
    if parent is not None:
        entries["parent"] = parent
    times = {}
    for name, fn in entries.items():
        for parts in ((1,) if name == "parent" else (1, 2, 4)):
            ws = torch.empty(tiles * parts * 64 * (d + 2), device="cuda")

            def call():
                build.check_launch("block_sparse_attention", fn(
                    0, d, d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    ids.data_ptr(), qs.data_ptr(), out.data_ptr(), B, S, T,
                    H, KVH, bs, nb, 1, 0.0, d ** -0.5, parts,
                    None if parts == 1 else ws.data_ptr(), stream()))
            call()
            torch.cuda.synchronize()
            _hold(f"K8 fp32 {name} parts={parts}", out, want, torch.float32)
            times[f"{name}_p{parts}"] = graph_ms(call, 20)

    def wrapper():
        return K8.block_sparse_attention(q, k, v, ids, qs, **kw)
    _hold("K8 fp32 wrapper", wrapper(), want, torch.float32)
    times["wrapper"] = cuda_ms(wrapper, 20)
    times["wrapper_device"] = graph_ms(wrapper, 20)
    G = H // KVH
    tok = (ids[0].long()[..., None] * bs
           + torch.arange(bs, device="cuda")).reshape(S // bs, nb * bs)
    kg, vg = (x[0][tok].permute(0, 2, 1, 3).repeat_interleave(G, 1)
              .contiguous() for x in (k, v))
    qb = q[0].reshape(S // bs, bs, H, d).transpose(1, 2).contiguous()
    qpos = start + torch.arange(S, device="cuda").reshape(S // bs, bs)
    mask = (tok[:, None, :] <= qpos[..., None])[:, None]
    times["sdpa"] = cuda_ms(lambda: F.scaled_dot_product_attention(
        qb, kg, vg, attn_mask=mask), 20)
    print(f"[sparse32] kernel=block_sparse_attention dtype=float32 "
          f"tiles={tiles} bound_3xtf32_ms={3 * flops / 494.7e12 * 1e3:.4f} "
          + " ".join(f"{k_}_ms={v_:.5f} {k_}_tflops={flops / v_ / 1e9:.1f}"
                     for k_, v_ in times.items()), flush=True)


def k6_case(variants, parent=None, Hi=16, tag="yi6b"):
    """K6's bf16 route at the DSA serve span (see ``indexer``) at ``Hi``
    heads of 64; each call on another layer of an 8-layer pool, so the keys
    come from device memory."""
    import numpy as np
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import prefill as K6
    Di, bs, S, start, layers, nbk = 64, 16, 256, 5888, 8, 2048
    mb = 6432 // bs
    rng = np.random.default_rng(SEED + 7)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    stride = nbk + 1
    kp = torch.randn((layers * stride, bs, Di), generator=gen,
                     device="cuda").bfloat16()
    live = (start + S - 1) // bs + 1
    t = np.full((1, mb), nbk, np.int32)
    t[0, :live] = rng.permutation(nbk)[:live]
    tables = [torch.from_numpy(t + g * stride).cuda() for g in range(layers)]
    st = torch.tensor([start], dtype=torch.int32, device="cuda")
    q = torch.randn((1, S * Hi, Di), generator=gen, device="cuda").bfloat16()
    w = torch.softmax(torch.randn((1, S, Hi), generator=gen, device="cuda"),
                      -1).reshape(1, S * Hi)
    out = torch.empty((1, S, mb * bs), device="cuda")
    want = [K6.paged_prefill_indexer_plain(q, w, kp, tb, st, heads=Hi)
            for tb in tables]
    it = iter(range(10 ** 9))
    entries = dict(variants)
    if parent is not None:
        entries["parent"] = parent
    times = {}
    for name, fn in entries.items():
        def call():
            g = next(it) % layers
            build.check_launch("paged_prefill_indexer", fn(
                1, Di, bs, q.data_ptr(), w.data_ptr(), kp.data_ptr(),
                tables[g].data_ptr(), st.data_ptr(), out.data_ptr(), 1,
                S * Hi, Hi, mb, Di ** -0.5, stream()))
            return g
        g = call()
        torch.cuda.synchronize()
        dead = want[g] <= -1e29
        _hold(f"K6 {name}", out.masked_fill(dead, 0.0),
              want[g].masked_fill(dead, 0.0), torch.bfloat16)
        times[name] = graph_ms(call, 32)

    def wrapper():
        return K6.paged_prefill_indexer(q, w, kp, tables[next(it) % layers],
                                        st, heads=Hi)
    times["wrapper"] = cuda_ms(wrapper, 32)
    times["wrapper_device"] = graph_ms(wrapper, 32)
    flops = S * live * bs * Hi * (2 * Di + 2)
    print(f"[indexer] kernel=paged_prefill_indexer case={tag} Hi={Hi} "
          f"Di={Di} S={S} "
          f"start={start} bound_ms={flops / 989e12 * 1e3:.5f} "
          f"wrapper_host_us={host_us(wrapper):.2f} " + " ".join(
              f"{k_}_ms={v_:.5f} {k_}_tflops={flops / v_ / 1e9:.1f}"
              for k_, v_ in times.items()), flush=True)


def k7_case(tag, dtype_name, S, T, variants, parent=None, layers=1):
    """K7 at Hi 16 / Di 64 (see ``lightning``): ``S`` queries against ``T``
    keys in ``dtype_name``, each call on another of ``layers`` key tensors;
    every built variant of the tensor-core body and the parent's entry
    point (CUDA-graph device times), held at the dtype's bound, beside the
    wrapper's time, device time and host microseconds a call."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.lightning_indexer import kernel as K7
    dtype = getattr(torch, dtype_name)
    Hi, Di = 16, 64
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    q = torch.randn((1, S, Hi * Di), generator=gen, device="cuda").to(dtype)
    w = torch.softmax(torch.randn((1, S, Hi), generator=gen, device="cuda"),
                      -1)
    ks = [torch.randn((1, T, Di), generator=gen, device="cuda").to(dtype)
          for _ in range(layers)]
    out = torch.empty((1, S, T), device="cuda")
    want = [K7.reference(q, w, k, heads=Hi, head_dim=Di) for k in ks]
    it = iter(range(10 ** 9))
    entries = dict(variants)
    if parent is not None:
        entries["parent"] = parent
    times = {}
    for name, fn in entries.items():
        def call():
            g = next(it) % layers
            build.check_launch("lightning_indexer", fn(
                build.DTYPE_CODE[dtype], Di, q.data_ptr(), w.data_ptr(),
                ks[g].data_ptr(), out.data_ptr(), 1, S, T, Hi, Di ** -0.5,
                stream()))
            return g
        g = call()
        torch.cuda.synchronize()
        _hold(f"K7 {tag} {name}", out, want[g], dtype)
        times[name] = graph_ms(call, 32)

    def wrapper():
        return K7.lightning_indexer(q, w, ks[next(it) % layers], heads=Hi,
                                    head_dim=Di)
    times["wrapper"] = cuda_ms(wrapper, 32)
    times["wrapper_device"] = graph_ms(wrapper, 32)
    flops = S * T * Hi * (2 * Di + 2)
    bound = 3 * flops / 494.7e12 if dtype == torch.float32 \
        else flops / 989e12
    print(f"[lightning] kernel=lightning_indexer case={tag} "
          f"dtype={dtype_name} Hi={Hi} Di={Di} S={S} T={T} "
          f"bound_ms={bound * 1e3:.5f} "
          f"wrapper_host_us={host_us(wrapper):.2f} " + " ".join(
              f"{k_}_ms={v_:.5f} {k_}_tflops={flops / v_ / 1e9:.1f}"
              for k_, v_ in times.items()), flush=True)


def k11_case(tag, B, S, dtype_name, variants, parent=None):
    """K11's model form at falcon-mamba's width (E 8192, N 16; see
    ``scan``): every built variant at every time split 1..16 it can take
    (the C entry point, CUDA events; CUDA-graph replay at S 1), held at
    the fp32 bound against the plain version, the wrapper (its own parts)
    and its host microseconds a call, and the parent's wrapper."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.mamba_scan import kernel as K11
    from repro_torch.kernels.mamba_scan import ref as R11
    from chip_smoke import H100_SFU_PER_S, _scan_inputs
    dtype = getattr(torch, dtype_name)
    E, N = 8192, 16
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    ins = _scan_inputs(gen, B, S, E, N, dtype, dtype, "cuda")
    dt, A, x, Bc, Cc, h0 = ins
    want = R11.scan_model(*ins)
    y = torch.empty((B, S, E), device="cuda")
    hT = torch.empty((B, E, N), device="cuda")
    code = build.DTYPE_CODE[dtype]
    timer = graph_ms if S == 1 else cuda_ms
    times = {}
    for name, fn in variants.items():
        for parts in (1, 2, 4, 8, 16):
            if parts > max(1, S // K11.MIN_CHUNK):
                continue
            ws = torch.empty(max(1, 2 * B * (parts - 1) * E * N),
                             device="cuda")

            def call():
                build.check_launch("mamba_scan_model", fn(
                    code, code, N, dt.data_ptr(), A.data_ptr(),
                    x.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
                    h0.data_ptr(), y.data_ptr(), hT.data_ptr(),
                    ws.data_ptr(), B, S, E, parts, stream()))
            call()
            torch.cuda.synchronize()
            _hold(f"K11 {tag} {name} parts={parts} y", y, want[0],
                  torch.float32)
            _hold(f"K11 {tag} {name} parts={parts} hT", hT, want[1],
                  torch.float32)
            times[f"{name}_p{parts}"] = timer(call, 20)

    def wrapper():
        return K11.mamba_scan_model(*ins)
    times["wrapper"] = cuda_ms(wrapper, 20)
    if S == 1:
        times["wrapper_device"] = graph_ms(wrapper, 20)
    host = {"wrapper_host_us": host_us(wrapper, 100)}
    if parent is not None:
        def old():
            return parent(*ins)
        got = old()
        _hold(f"K11 {tag} parent y", got[0], want[0], torch.float32)
        times["parent"] = cuda_ms(old, 20)
        if S == 1:
            times["parent_device"] = graph_ms(old, 20)
        host["parent_host_us"] = host_us(old, 100)
    parts = K11.scan_parts(code, code, N, B, S, E, torch.cuda.current_device())
    print(f"[scan] kernel=mamba_scan_model case={tag} dtype={dtype_name} "
          f"B={B} S={S} E={E} N={N} wrapper_parts={parts} "
          f"sfu_bound_ms={B * S * E * N / H100_SFU_PER_S * 1e3:.5f} "
          + " ".join(f"{k}_ms={v:.5f}" for k, v in times.items()) + " "
          + " ".join(f"{k}={v:.2f}" for k, v in host.items()), flush=True)


def k3_decode_case(variants, parent=None):
    """K3 (bf16) at GLM-5's decode step (see ``mla_decode``); ``parent``
    the other revision's K3 wrapper."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import kernel as K3
    B, H, L, R, bs, layers, nbk = 8, 64, 512, 64, 16, 8, 2048
    lens = np.asarray(SERVE_LENS, np.int32)
    mb = (max(SERVE_LENS) + 256) // bs + 1
    scale = 192 ** -0.5
    rng = np.random.default_rng(SEED + 12)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    c = torch.randn((layers * (nbk + 1), bs, L), generator=gen,
                    device="cuda").bfloat16()
    kr = torch.randn((layers * (nbk + 1), bs, R), generator=gen,
                     device="cuda").bfloat16()
    tables = _decode_tables(rng, lens, bs, mb, nbk, layers)
    sl = torch.from_numpy(lens).cuda()
    ql = torch.randn((B, H, L), generator=gen, device="cuda")
    qr = torch.randn((B, H, R), generator=gen, device="cuda").bfloat16()
    out = torch.empty_like(ql)
    want = [K3.paged_decode_mla_plain(ql, qr, c, kr, tb, sl, scale=scale)
            for tb in tables]
    it = iter(range(10 ** 9))
    times = {}
    for name, fn in variants.items():
        for parts in (1, 2, 4, 8, 16):
            ws = torch.empty(K3.mla_decode_workspace(B, H, L, parts),
                             device="cuda")

            def call():
                g = next(it) % layers
                build.check_launch("paged_decode_mla", fn(
                    1, L, R, bs, ql.data_ptr(), qr.data_ptr(), c.data_ptr(),
                    kr.data_ptr(), tables[g].data_ptr(), sl.data_ptr(),
                    out.data_ptr(), B, H, mb, scale, parts, ws.data_ptr(),
                    stream()))
                return g
            g = call()
            torch.cuda.synchronize()
            _hold(f"K3 {name} parts={parts}", out, want[g], torch.bfloat16)
            times[f"{name}_p{parts}"] = graph_ms(call, 32)

    def wrapper():
        return K3.paged_decode_mla(ql, qr, c, kr, tables[next(it) % layers],
                                   sl, scale=scale)
    it = iter(range(10 ** 9))
    _hold("K3 wrapper", wrapper(), want[0], torch.bfloat16)
    times["wrapper"] = cuda_ms(wrapper, 32)
    times["wrapper_device"] = graph_ms(wrapper, 32)
    host = {"wrapper_host_us": host_us(wrapper)}
    if parent is not None:
        def old():
            return parent(ql, qr, c, kr, tables[next(it) % layers], sl,
                          scale=scale)
        it = iter(range(10 ** 9))         # old's first: layer 0
        _hold("K3 parent", old(), want[0], torch.bfloat16)
        times["parent"] = cuda_ms(old, 32)
        times["parent_device"] = graph_ms(old, 32)
        host["parent_host_us"] = host_us(old)
    T = int(lens.max()) + 1
    views = []
    for tb in tables[:2]:
        cv = c[tb.long()].reshape(B, -1, L)[:, :T]
        k = torch.cat([cv, kr[tb.long()].reshape(B, -1, R)[:, :T]], -1)
        views.append((k[:, None].expand(B, H, T, L + R).contiguous(),
                      cv[:, None].expand(B, H, T, L).contiguous()))
    mask = (torch.arange(T, device="cuda")[None, :]
            <= sl[:, None].long())[:, None, None, :]
    qs = torch.cat([ql.bfloat16(), qr], -1)[:, :, None]
    times["sdpa_device"] = graph_ms(lambda: F.scaled_dot_product_attention(
        qs, *views[next(it) % 2], attn_mask=mask, scale=scale), 32)
    toks = int((lens + 1).sum())
    nbytes = toks * (L + R) * 2 + ql.numel() * 4 * 2 + qr.numel() * 2 \
        + B * mb * 4 + B * 4
    parts = K3.mla_decode_parts(B, H, L, R, mb, torch.cuda.current_device())
    print(f"[mla_decode] kernel=paged_decode_mla B={B} H={H} bs={bs} "
          f"wrapper_parts={parts[0]} bound_ms={nbytes / 3.35e12 * 1e3:.5f} "
          + " ".join(f"{k}_ms={v:.5f}" for k, v in times.items()) + " "
          + " ".join(f"{k}={v:.2f}" for k, v in host.items()), flush=True)


def k5_decode_case(tag, Hi, Di, parent=None):
    """K5 (bf16) at the DSA serve phase's decode step (see
    ``indexer_decode``); ``parent`` the other revision's K5 wrapper."""
    import numpy as np
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import kernel as K5
    B, bs, layers, nbk = 8, 16, 8, 2048
    lens = np.asarray(DSA_LENS, np.int32)
    mb = 6432 // bs
    rng = np.random.default_rng(SEED + 13)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    kp = torch.randn((layers * (nbk + 1), bs, Di), generator=gen,
                     device="cuda").bfloat16()
    tables = _decode_tables(rng, lens, bs, mb, nbk, layers)
    sl = torch.from_numpy(lens).cuda()
    q = torch.randn((B, Hi, Di), generator=gen, device="cuda").bfloat16()
    w = torch.softmax(torch.randn((B, Hi), generator=gen, device="cuda"), -1)
    out = torch.empty((B, mb * bs), device="cuda")
    want = [K5.paged_indexer_scores_plain(q, w, kp, tb, sl) for tb in tables]
    it = iter(range(10 ** 9))

    def held(what, got, g):
        dead = want[g] <= -1e29
        if not torch.equal(got <= -1e29, dead):
            raise AssertionError(f"{what}: dead blocks differ")
        _hold(what, got.masked_fill(dead, 0.0),
              want[g].masked_fill(dead, 0.0), torch.bfloat16)
    fn = build.cuda_entry("paged_indexer_scores")

    def call():
        g = next(it) % layers
        build.check_launch("paged_indexer_scores", fn(
            1, Di, bs, q.data_ptr(), w.data_ptr(), kp.data_ptr(),
            tables[g].data_ptr(), sl.data_ptr(), out.data_ptr(), B, Hi, mb,
            Di ** -0.5, stream()))
        return g
    g = call()
    torch.cuda.synchronize()
    held(f"K5 {tag} entry", out, g)
    times = {"entry": graph_ms(call, 64)}

    def wrapper():
        return K5.paged_indexer_scores_kernel(q, w, kp,
                                              tables[next(it) % layers], sl)
    it = iter(range(10 ** 9))
    held(f"K5 {tag} wrapper", wrapper(), 0)
    times["wrapper"] = cuda_ms(wrapper, 64)
    times["wrapper_device"] = graph_ms(wrapper, 64)
    host = {"wrapper_host_us": host_us(wrapper)}
    if parent is not None:
        def old():
            return parent(q, w, kp, tables[next(it) % layers], sl)
        it = iter(range(10 ** 9))
        held(f"K5 {tag} parent", old(), 0)
        times["parent"] = cuda_ms(old, 64)
        times["parent_device"] = graph_ms(old, 64)
        host["parent_host_us"] = host_us(old)
    toks = sum(int(n) // bs + 1 for n in lens) * bs
    nbytes = toks * Di * 2 + q.numel() * 2 + w.numel() * 4 \
        + B * mb * bs * 4 + B * mb * 4 + B * 4
    print(f"[indexer_decode] kernel=paged_indexer_scores_kernel case={tag} "
          f"B={B} Hi={Hi} Di={Di} bs={bs} view={mb * bs} "
          f"bound_ms={nbytes / 3.35e12 * 1e3:.5f} "
          + " ".join(f"{k}_ms={v:.5f}" for k, v in times.items()) + " "
          + " ".join(f"{k}={v:.2f}" for k, v in host.items()), flush=True)


def ssd_heads_case(tag, B, S, dtype_name, reps=20):
    """K11's head-shared chunked route (``csrc/ssd_scan.cuh``) at zamba2's
    width (80 heads of 64, N 64): at every divisor of 80 up to
    ``MAX_CHUNK_HEADS`` heads a chunk CTA, device milliseconds from
    CUDA-graph replay in turns against the wrapper (its ``chunk_heads``),
    each held at the fp32 bound against the plain version, and each
    kernel's device microseconds a call (``torch.profiler``)."""
    import torch
    from repro_torch.kernels.mamba_scan import kernel as K11
    from repro_torch.kernels.mamba_scan import ref as R11
    from chip_smoke import _chunked_breakdown, _head_scan_inputs
    dtype = getattr(torch, dtype_name)
    H, P, N = 80, 64, 64
    gen = torch.Generator(device="cuda").manual_seed(SEED + 28)
    ins = _head_scan_inputs(gen, B, S, H, P, N, dtype, dtype, "cuda")
    want = R11.scan_heads(*ins)
    code = K11.DTYPE_CODE[dtype]
    rule = K11.chunk_heads(code, code, N, B, S, H,
                           torch.cuda.current_device())

    def wrapper():
        return K11.mamba_scan_heads(*ins)
    for heads in [h for h in range(1, K11.MAX_CHUNK_HEADS + 1) if H % h == 0]:
        def forced(heads=heads):
            return K11.launch_scan_heads_chunked(*ins, heads)
        got = forced()
        _hold(f"K11 ssd {tag} heads={heads} y", got[0], want[0],
              torch.float32)
        del got
        times = alternate(forced, wrapper,
                          measure=lambda fn: graph_ms(fn, reps))
        split = _chunked_breakdown(forced)
        print(f"[ssd_heads] case={tag} B={B} S={S} dtype={dtype_name} "
              f"heads={heads} wrapper_heads={rule} "
              f"forced_ms={','.join(f'{x:.5f}' for x in times['new'])} "
              f"wrapper_ms={','.join(f'{x:.5f}' for x in times['old'])} "
              + " ".join(f"{k}={v:.2f}" for k, v in split.items()),
              flush=True)


class _parent_scan_body:
    """Inside ``with _parent_scan_body():`` K11's head-shared wrapper runs the
    parent's thread-a-channel body at the time split its wrapper picked
    (``launch_scan_heads`` at ``scan_parts``), as the parent's wrapper
    did; restored on exit."""

    def __enter__(self):
        from repro_torch.kernels.mamba_scan import kernel as K11
        self._saved = K11.mamba_scan_heads

        def parent(dt, A, x, Bc, Cc, h0):
            B, S, H, P, N, index = K11.check_cuda_args_heads(dt, A, x, Bc,
                                                             Cc, h0)
            parts = K11.scan_parts(K11.DTYPE_CODE[x.dtype],
                                   K11.DTYPE_CODE[h0.dtype], N, B, S, H * P,
                                   index, "mamba_scan_heads_resources")
            return K11.launch_scan_heads(dt, A, x, Bc, Cc, h0, parts)
        K11.mamba_scan_heads = parent
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels.mamba_scan import kernel as K11
        K11.mamba_scan_heads = self._saved
        return False


def dsa_flips_case(seed, layers=12, seq=2560, device="cuda"):
    """zamba2 + DSA's token selections as ``chip_smoke.py``'s train parity
    makes them (``layers`` layers, B 1, S ``seq``: past top-k 2048), the
    weights and tokens from ``seed``: the forward of ``hybrid.loss`` on
    the kernel route, on the kernel route with K11's head-shared form on
    the parent's thread-a-channel body, and on the plain route
    (``chip_smoke.plain_route``).  Against the plain route's, each of the
    first two's top-k selections: the indices that differ, those of them
    at near-ties (the plain score within the fp32 tolerance x min(1,
    max|score|) of the k-th plain score: ``chip_smoke._TopkAlign``'s rule)
    and the others, the farthest differing index's distance from the k-th
    score over that tolerance, and the largest score difference relative
    to the call's max |plain score|."""
    import contextlib
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import dsa
    from repro_torch.models import get_model
    from chip_smoke import TOL, _free, plain_route
    cfg = get_config("zamba2_2p7b").replace(num_layers=layers)
    M = get_model(cfg)
    model = M.init(cfg, torch.Generator(device=device).manual_seed(seed),
                   device=device)
    toks = np.random.default_rng(seed + 3).integers(0, cfg.vocab_size,
                                                    (1, seq + 1))
    t = torch.from_numpy(toks.astype(np.int32)).to(device)
    batch = {"tokens": t[:, :-1], "targets": t[:, 1:]}
    select = dsa.select_topk

    def selections(route):
        calls = []

        def record(scores, mask, k):
            sel, valid = select(scores, mask, k)
            calls.append((sel, valid, scores.detach().clone(), mask, k))
            return sel, valid
        dsa.select_topk = record
        try:
            with route:
                loss = float(M.loss(model, batch)[0])
        finally:
            dsa.select_topk = select
        return loss, calls

    def chosen(scores, idx, ok):
        out = torch.zeros(scores.shape, dtype=torch.bool,
                          device=scores.device)
        return out.scatter_(-1, idx, ok)
    loss_p, plain = selections(plain_route())
    for name, route in (("kernel", contextlib.nullcontext()),
                        ("parent_body", _parent_scan_body())):
        loss, calls = selections(route)
        if len(calls) != len(plain):
            raise AssertionError(f"dsa_flips: {len(calls)} selections "
                                 f"against {len(plain)}")
        per_call, near, gap, reach = [], 0, 0.0, 0.0
        for (sel, valid, scores, mask, k), (sel_p, valid_p, scores_p, _, _) \
                in zip(calls, plain):
            live = scores_p.masked_fill(~mask, 0.0)
            top = live.abs().max().clamp_min(1e-30)
            gap = max(gap, ((scores.masked_fill(~mask, 0.0) - live).abs()
                            .max() / top).item())
            diff = chosen(scores, sel, valid) ^ chosen(scores_p, sel_p,
                                                      valid_p)
            per_call.append(int(diff.sum()))
            if not per_call[-1]:
                continue
            kth = torch.where(mask, scores_p, float("-inf")).topk(
                min(k, scores_p.shape[-1]), dim=-1).values[..., -1:]
            tol = TOL["float32"] * min(1.0, top.item())
            off = (scores_p - kth).abs()
            reach = max(reach, torch.where(diff, off, 0.0).max().item() / tol)
            near += int((diff & (off <= tol)).sum())
        print(f"[dsa_flips] seed={seed} layers={layers} seq={seq} "
              f"route={name} calls={len(calls)} "
              f"differing={sum(per_call)} near_ties={near} "
              f"far={sum(per_call) - near} "
              f"max_dist_over_tol={reach:.4g} max_rel_score_gap={gap:.4g} "
              f"loss={loss:.7f} plain_loss={loss_p:.7f} "
              f"per_call={per_call}", flush=True)
        del calls
    del model, plain
    _free()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", type=Path, default=None,
                        help="another revision's src/repro_torch/csrc, its "
                             "kernels/ beside it")
    parser.add_argument("--only", default=None,
                        help="comma-separated studies to run (split, mla, "
                             "tf32, decode, ce, sparse32, indexer, lightning, "
                             "scan, mla_decode, indexer_decode, flash_bf16, "
                             "ssd_heads, dsa_flips); "
                             "all by "
                             "default")
    args = parser.parse_args()
    only = None if args.only is None else set(args.only.split(","))

    def run(study):
        return only is None or study in only
    import torch
    if not torch.cuda.is_available():
        print("tile_study: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip() or smi.stderr.strip(), flush=True)
    build.build_all(build.LIBRARIES)
    for query, insts in (("paged_prefill_gqa_resources",
                          [(d, bs) for d in (64, 128, 256)
                           for bs in (8, 16, 32)]),
                         ("block_sparse_resources",
                          [(c, 64, 64) for c in (0, 1)]
                          + [(c, 128, 128) for c in (0, 1)]
                          + [(c, 192, 256) for c in (0, 1)]),
                         ("paged_prefill_indexer_resources",
                          [(hi, di) for hi in (8, 16, 32)
                           for di in (16, 32, 64, 128)]),
                         ("paged_indexer_scores_resources",
                          [(hi, di) for hi in (16, 32)
                           for di in (16, 32, 64, 128)]),
                         ("lightning_indexer_resources",
                          [(c, hi, di) for c in (0, 1) for hi in (16, 32)
                           for di in (16, 32, 64, 128)]),
                         ("paged_mla_resources",
                          [(0, 512, 64), (1, 512, 64)]),
                         ("flash_attention_resources",
                          [(c, d) for c in (0, 1) for d in (64, 128, 256)]),
                         ("paged_decode_gqa_resources",
                          [(c, d, bs) for c in (0, 1) for d in (64, 128, 256)
                           for bs in (8, 16, 32)]),
                         ("chunked_ce_resources", [(0,), (1,)]),
                         ("mamba_scan_model_resources",
                          [(c, h, n) for c in (0, 1) for h in (0, 1)
                           for n in (8, 16, 32)])):
        for inst in insts:
            regs, spill, smem, ctas, rows = build.resources(query, *inst)
            print(f"[resources] query={query} instance="
                  f"{'x'.join(map(str, inst))} registers={regs} "
                  f"spill_bytes={spill} smem_bytes={smem} "
                  f"ctas_per_sm={ctas} rows_per_cta={rows}", flush=True)
    studied = variant_libraries(run)
    parent = parent_libraries(args.parent, run) if args.parent else {}
    # K2 and K8: the serve shapes of chip_smoke.py, then grids of 8 to 512
    # tiles
    if run("split"):
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
        if parent:
            sass_against_parent()
    # K4: GLM-5's serve chunk, its verify span (spec 3 over the serve
    # lengths), a first chunk
    if run("mla"):
        mla = {"mla_k32_s2": build.cuda_entry("paged_prefill_mla")}
        mla.update({k: v for k, v in studied.items() if k.startswith("mla_")})
        k4_kw = dict(variants=mla, parent=parent.get("paged_prefill_mla"),
                     sdpa=True)
        k4_case("serve", 1, 64, 16, [768], 256, **k4_kw)
        k4_case("verify", 8, 64, 16, [1040, 48, 793, 166, 528, 80, 916, 316],
                4, **k4_kw)
        k4_case("first-chunk", 1, 64, 16, [0], 256, **k4_kw)
    # K9: Yi-6B's training layer, d 64 and gemma2's d 256, a window
    if run("tf32"):
        tf32 = {"tf32_k32": build.cuda_entry("flash_attention")}
        tf32.update({k: v for k, v in studied.items()
                     if k.startswith("tf32")})
        k9_kw = dict(variants=tf32, parent=parent.get("flash_attention"))
        k9_case("train", 2, 2048, 32, 4, 128, sdpa=True, **k9_kw)
        k9_case("d64", 2, 2048, 32, 4, 64, sdpa=True, **k9_kw)
        k9_case("d256", 2, 2048, 8, 4, 256, sdpa=True, **k9_kw)
        k9_case("window-512", 2, 2048, 32, 4, 128, window=512, **k9_kw)
    # K1: Yi-6B's decode step, both dtypes
    if run("decode"):
        for dtype_name in ("bfloat16", "float32"):
            k1_case(dtype_name, parent=parent.get("paged_decode_gqa"))
    # K10: Yi-6B's training step, every tile size
    if run("ce"):
        ce = {"ce_m64_s3": build.cuda_entry("chunked_ce")}
        ce.update({k: v for k, v in studied.items() if k.startswith("ce_")})
        k10_case(ce, parent=parent.get("chunked_ce"))
    # K8's fp32 route: the block selector's training chunk, every tile size
    if run("sparse32"):
        sparse32 = {"sparse32_k32":
                    build.cuda_entry("block_sparse_attention")}
        sparse32.update({k: v for k, v in studied.items()
                         if k.startswith("sparse32")})
        k8_fp32_case(sparse32, parent=parent.get("block_sparse_attention"))
    # K6's bf16 route: the DSA serve span, every tile size
    if run("indexer"):
        idx = {"idx_t4_r4": build.cuda_entry("paged_prefill_indexer")}
        idx.update({k: v for k, v in studied.items() if k.startswith("idx_")})
        k6_case(idx, parent=parent.get("paged_prefill_indexer"))
        # zamba2's 8 x 64 (the parent ran it on the SIMT tile)
        idx8 = {"idx8_t4_r4": build.cuda_entry("paged_prefill_indexer")}
        idx8.update({k: v for k, v in studied.items()
                     if k.startswith("idx8_")})
        k6_case(idx8, parent=parent.get("paged_prefill_indexer"), Hi=8,
                tag="zamba2")
    # K9's bf16 route: the RL loop backend's re-forward, shorter and
    # longer sequences, d 256
    if run("flash_bf16"):
        for tag, B, S, H, KVH, d in (("loop", 1, 240, 32, 4, 128),
                                     ("s128", 1, 128, 32, 4, 128),
                                     ("s512", 1, 512, 32, 4, 128),
                                     ("loop-d256", 1, 240, 8, 4, 256),
                                     ("b4", 4, 240, 32, 4, 128)):
            k9_bf16_case(tag, B, S, H, KVH, d,
                         parent=parent.get("flash_attention"),
                         parent_wrapper=parent.get("flash_attention_wrapper"))
    # K7: the DSA training chunk (fp32, 3xTF32) and the block selector's
    # last serve span of the 6144-token prompt over its 6528-position view
    # (bf16), every tile size of each route
    if run("lightning"):
        li32 = {"li32_t2_r8_k64": build.cuda_entry("lightning_indexer")}
        li32.update({k: v for k, v in studied.items()
                     if k.startswith("li32")})
        k7_case("train-chunk", "float32", 256, 4096, li32,
                parent=parent.get("lightning_indexer"))
        li = {"li_t4_r4": build.cuda_entry("lightning_indexer")}
        li.update({k: v for k, v in studied.items() if k.startswith("li_")})
        k7_case("serve-span", "bfloat16", 256, 6528, li,
                parent=parent.get("lightning_indexer"), layers=8)
    # K11: falcon-mamba's serve prefill, training shape and decode step,
    # every steps-a-round build at every time split
    if run("scan"):
        scan = {"scan_s4": build.cuda_entry("mamba_scan_model")}
        scan.update({k: v for k, v in studied.items()
                     if k.startswith("scan")})
        k11_kw = dict(variants=scan, parent=parent.get("mamba_scan_model"))
        k11_case("prefill", 8, 1024, "bfloat16", **k11_kw)
        k11_case("train", 2, 2048, "float32", **k11_kw)
        k11_case("train-b4", 4, 2048, "float32", **k11_kw)
        k11_case("decode", 8, 1, "bfloat16", **k11_kw)
    # K3: GLM-5's decode step, keys a round x parts
    if run("mla_decode"):
        mlad = {"mlad_k32": build.cuda_entry("paged_decode_mla")}
        mlad.update({k: v for k, v in studied.items()
                     if k.startswith("mlad")})
        k3_decode_case(mlad, parent=parent.get("paged_decode_mla"))
    # K11's head-shared chunked route: heads a chunk CTA at zamba2's
    # prefill span and training shape
    if run("ssd_heads"):
        ssd_heads_case("span", 1, 256, "bfloat16")
        ssd_heads_case("train", 2, 2048, "float32", reps=5)
    # zamba2 + DSA's top-k selections on the kernel route, with the parent's
    # scan body, against the plain route, at four seeds
    if run("dsa_flips"):
        for seed in (0, 1, 2, 3):
            dsa_flips_case(seed)
    # K5: the DSA serve phase's decode step at Yi-6B's, GLM-5's and
    # zamba2's (one n-tile of heads) indexer shapes
    if run("indexer_decode"):
        for tag, hi, di in (("yi6b", 16, 64), ("glm5", 32, 128),
                            ("zamba2", 8, 64)):
            k5_decode_case(tag, hi, di,
                           parent=parent.get("paged_indexer_scores"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
