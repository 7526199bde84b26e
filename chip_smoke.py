#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one line of numbers (any failure exits non-zero):

  build    compile the hand-written CUDA kernels from ``src/repro_torch/csrc``
           with nvcc for sm_90a into ``build/`` (cached by source hash);
  kernels  K1 (paged decode) and K2 (span prefill) against their plain
           PyTorch versions at Yi-6B shapes (KVH 4, G 8, d 128) and a
           gemma2-like shape (KVH 4, G 2, d 256, window 64, softcap 50),
           block sizes 16 and 8, fp32 (atol 1e-4) and bf16 (atol 2e-2, one
           bf16 ulp at unit scale plus summation order), on ragged rows:
           a trash row of length 0, length 1, block boundaries, a span
           starting mid-block, shuffled tables;
  timing   each kernel, its plain version and one PyTorch library call
           (scaled_dot_product_attention over the KV gathered and its heads
           repeated once, before the timed loop; timed here only, the port
           never calls it) at the serve phase's shapes, with the least time
           the card could take (bytes over 3.35 TB/s or flops over 989
           TFLOP/s, whichever is larger); at these shapes each kernel is
           also held against its plain version, in bf16 and in fp32, with
           the tolerances above scaled by min(1, max|plain|);
  parity   Yi-6B at full width with 2 layers in fp32: the port's
           ContinuousEngine (mid-flight admission, a shared prefix with a
           radix hit and a COW fork, chunked prefill) gives the same greedy
           tokens as the ServingEngine oracle, wherever the top-2 logit
           margin is at least 1e-3 (prompts without one are skipped);
  serve    Yi-6B at full width and depth (32 layers, dsa=None) in bf16 on a
           2 GiB pool: 8 requests of 32..1024 prompt tokens, half sharing a
           system prefix, prefill_chunk 256.  The kernels' launch counters
           are set to 0 just before and read just after this run.

  profile  8 decode-only steps of the full model at 8 rows, timed and then
           traced with torch.profiler: device busy share, top kernels.

Then it prints the kernels' JSON line, the card's name and power limit, and
as its last line ``{"ok": true, "device": {...}}``.  Without a GPU, or
without the repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
SEED = 0

H100_BYTES_PER_S = 3.35e12       # HBM3, SXM data sheet
H100_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, tensor/FP32
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _log(phase: str, **nums) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in nums.items()),
          flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device milliseconds per call of ``fn`` (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


# ---------------------------------------------------------------------------
# kernels vs plain versions
# ---------------------------------------------------------------------------

def _pool(gen, nb, bs, kvh, d, dtype, device, layers=1):
    import torch
    shape = (layers * nb, bs, kvh, d)
    k = torch.randn(shape, generator=gen, device=device).to(dtype)
    v = torch.randn(shape, generator=gen, device=device).to(dtype)
    return k, v


def _tables(rng, B, mb, trash, live_blocks):
    """Disjoint shuffled blocks per row (row b owns live_blocks[b]); the
    rest of every row points at the trash block."""
    import numpy as np
    ids = rng.permutation(trash)
    t = np.full((B, mb), trash, np.int32)
    at = 0
    for b, n in enumerate(live_blocks):
        t[b, :n] = ids[at:at + n]
        at += n
    return t


def check_kernels(device="cuda") -> dict:
    """K1/K2 vs plain on ragged rows; returns the max error per kernel."""
    import numpy as np
    import torch
    from repro_torch.kernels.paged_attention import kernel as K1
    from repro_torch.kernels.paged_attention import prefill as K2
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=device).manual_seed(SEED)
    worst = {"paged_decode_gqa": 0.0, "paged_prefill_gqa": 0.0}
    shapes = [("yi6b", 4, 8, 128, 0, 0.0), ("gemma2like", 4, 2, 256, 64, 50.0)]
    for name, kvh, G, d, window, softcap in shapes:
        for bs in (16, 8):
            mb = 12
            for dtype in (torch.float32, torch.bfloat16):
                tol = TOL[str(dtype).split(".")[1]]
                # decode: trash row (len 0), 1 token, block edges, deep row
                lens = [0, 1, bs - 1, bs, 2 * bs + 3, mb * bs - 1]
                B = len(lens)
                live = [0] + [l // bs + 1 for l in lens[1:]]
                trash = sum(live)
                kp, vp = _pool(gen, trash + 1, bs, kvh, d, dtype, device)
                tables = torch.from_numpy(
                    _tables(rng, B, mb, trash, live)).to(device)
                sl = torch.tensor(lens, dtype=torch.int32, device=device)
                q = torch.randn((B, kvh, G, d), generator=gen,
                                device=device).to(dtype)
                got = K1.paged_decode_gqa(q, kp, vp, tables, sl,
                                          window=window, softcap=softcap)
                want = K1.paged_decode_gqa_plain(q, kp, vp, tables, sl,
                                                 window=window,
                                                 softcap=softcap)
                err = (got.float() - want.float()).abs().max().item()
                if not torch.isfinite(got).all() or err > tol:
                    raise AssertionError(f"K1 {name} bs={bs} {dtype}: max "
                                         f"err {err} > {tol} or non-finite")
                worst["paged_decode_gqa"] = max(worst["paged_decode_gqa"],
                                                err)
                # span prefill: start 0, mid-block, at a block edge
                S = 37
                starts = [0, bs + bs // 2, 2 * bs, mb * bs - S]
                B = len(starts)
                live = [(s + S - 1) // bs + 1 for s in starts]
                trash = sum(live)
                kp, vp = _pool(gen, trash + 1, bs, kvh, d, dtype, device)
                tables = torch.from_numpy(
                    _tables(rng, B, mb, trash, live)).to(device)
                st = torch.tensor(starts, dtype=torch.int32, device=device)
                q = torch.randn((B, kvh, S * G, d), generator=gen,
                                device=device).to(dtype)
                got = K2.paged_prefill_gqa(q, kp, vp, tables, st, groups=G,
                                           window=window, softcap=softcap)
                want = K2.paged_prefill_gqa_plain(q, kp, vp, tables, st,
                                                  groups=G, window=window,
                                                  softcap=softcap)
                err2 = (got.float() - want.float()).abs().max().item()
                if not torch.isfinite(got).all() or err2 > tol:
                    raise AssertionError(f"K2 {name} bs={bs} {dtype}: max "
                                         f"err {err2} > {tol} or non-finite")
                worst["paged_prefill_gqa"] = max(worst["paged_prefill_gqa"],
                                                 err2)
                _log("kernels", shape=name, block_size=bs,
                     dtype=str(dtype).split(".")[1], k1_max_abs_err=err,
                     k2_max_abs_err=err2, tol=tol)
    return worst


# ---------------------------------------------------------------------------
# timing at the serve phase's shapes
# ---------------------------------------------------------------------------

def _gathered(pool, tables, T, groups):
    """The KV of ``tables``' rows as one dense (B, KVH*groups, T, d) tensor,
    KV heads repeated to the query heads: the input the library call is
    handed, made once, outside its timed loop."""
    from repro_torch.core.paging import paged_view
    x = paged_view(pool, tables)[:, :T].transpose(1, 2)
    return x.repeat_interleave(groups, dim=1).contiguous()


def _hold(what, got, want, dtype) -> float:
    """Fail unless the kernel's output is finite and within the stated
    tolerance of its plain version's: max abs error <= TOL[dtype] *
    min(1, max|plain|).  That is the unit-scale atol, made relative when the
    outputs are small: an output row over ~1000 live keys averages them, so
    at the serve shapes |out| is ~0.05 and a bare atol would hide a wrong
    kernel.  Returns the max abs error."""
    import torch
    name = str(dtype).split(".")[1]
    err = (got.float() - want.float()).abs().max().item()
    tol = TOL[name] * min(1.0, want.float().abs().max().item())
    if not torch.isfinite(got).all() or err > tol:
        raise AssertionError(f"{what} {name}: max abs err {err} > {tol} "
                             f"or non-finite")
    return err


def time_kernels(cfg, serve_lens, max_prompt, bs, num_blocks, chunk,
                 device="cuda", reps=64) -> dict:
    """Each kernel over every layer's rows of a full-size layer-major pool
    (as one decode step / prefill chunk of the serve phase reads them), so
    the KV comes from device memory, not the L2 cache."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import kernel as K1
    from repro_torch.kernels.paged_attention import prefill as K2
    dtype = torch.bfloat16
    L, kvh, d = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    G = cfg.num_heads // kvh
    item = 2
    stride = num_blocks + 1
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=device).manual_seed(SEED)
    kp, vp = _pool(gen, stride, bs, kvh, d, dtype, device, layers=L)
    mb = (max(max(serve_lens), max_prompt) + chunk) // bs + 1
    out = {}

    # K1: one decode step's batch
    lens = np.asarray(serve_lens, np.int32)
    B = len(lens)
    live = [int(l) // bs + 1 for l in lens]
    tables = torch.from_numpy(_tables(rng, B, mb, num_blocks, live)).to(device)
    per_layer = [tables + g * stride for g in range(L)]
    sl = torch.from_numpy(lens).to(device)
    q = torch.randn((B, kvh, G, d), generator=gen, device=device).to(dtype)
    it = iter(range(10 ** 9))
    ms = cuda_ms(lambda: K1.paged_decode_gqa(
        q, kp, vp, per_layer[next(it) % L], sl), reps)
    plain_ms = cuda_ms(lambda: K1.paged_decode_gqa_plain(
        q, kp, vp, per_layer[next(it) % L], sl), max(4, reps // 8))
    T = int(lens.max()) + 1
    kv_views = [(_gathered(kp, t, T, G), _gathered(vp, t, T, G))
                for t in per_layer[:8]]
    mask = (torch.arange(T, device=device)[None, :]
            <= sl[:, None].long())[:, None, None, :]
    qs = q.reshape(B, kvh * G, 1, d)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qs, *kv_views[next(it) % 8], attn_mask=mask), reps)
    del kv_views
    # held against the plain version at these shapes, in bf16 and in fp32
    # (layer 0's blocks: the tables without a layer offset)
    err = _hold("K1 serve-shape", K1.paged_decode_gqa(q, kp, vp, tables, sl),
                K1.paged_decode_gqa_plain(q, kp, vp, tables, sl), dtype)
    q32, k32, v32 = q.float(), kp[:stride].float(), vp[:stride].float()
    err32 = _hold("K1 serve-shape",
                  K1.paged_decode_gqa(q32, k32, v32, tables, sl),
                  K1.paged_decode_gqa_plain(q32, k32, v32, tables, sl),
                  torch.float32)
    toks = int((lens + 1).sum())
    nbytes = toks * kvh * d * 2 * item + 2 * q.numel() * item \
        + tables.numel() * 4 + B * 4
    flops = 4 * toks * G * kvh * d
    out["paged_decode_gqa"] = dict(
        ms=ms, plain_ms=plain_ms, library_ms=lib_ms, max_abs_err=err,
        max_abs_err_fp32=err32, bytes=nbytes, flops=flops,
        shape=f"B={B} lens={lens.tolist()}")

    # K2: the last prefill chunk of the longest prompt
    start = ((max_prompt - 1) // chunk) * chunk
    S = max_prompt - start
    live = [(start + S - 1) // bs + 1]
    tables = torch.from_numpy(_tables(rng, 1, mb, num_blocks, live)).to(device)
    per_layer = [tables + g * stride for g in range(L)]
    st = torch.tensor([start], dtype=torch.int32, device=device)
    q = torch.randn((1, kvh, S * G, d), generator=gen, device=device).to(dtype)
    ms = cuda_ms(lambda: K2.paged_prefill_gqa(
        q, kp, vp, per_layer[next(it) % L], st, groups=G), reps // 4)
    plain_ms = cuda_ms(lambda: K2.paged_prefill_gqa_plain(
        q, kp, vp, per_layer[next(it) % L], st, groups=G), 4)
    T = start + S
    kv_views = [(_gathered(kp, t, T, G), _gathered(vp, t, T, G))
                for t in per_layer[:8]]
    qpos = start + torch.arange(S, device=device)
    mask = (torch.arange(T, device=device)[None, :] <= qpos[:, None])
    qs = q.reshape(1, kvh, S, G, d).permute(0, 1, 3, 2, 4) \
        .reshape(1, kvh * G, S, d)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qs, *kv_views[next(it) % 8], attn_mask=mask), reps // 4)
    del kv_views
    err = _hold("K2 serve-shape",
                K2.paged_prefill_gqa(q, kp, vp, tables, st, groups=G),
                K2.paged_prefill_gqa_plain(q, kp, vp, tables, st, groups=G),
                dtype)
    q32, k32, v32 = q.float(), kp[:stride].float(), vp[:stride].float()
    err32 = _hold("K2 serve-shape",
                  K2.paged_prefill_gqa(q32, k32, v32, tables, st, groups=G),
                  K2.paged_prefill_gqa_plain(q32, k32, v32, tables, st,
                                             groups=G), torch.float32)
    del q32, k32, v32
    keys = sum(start + i + 1 for i in range(S))
    nbytes = T * kvh * d * 2 * item + 2 * q.numel() * item \
        + tables.numel() * 4 + 4
    flops = 4 * keys * G * kvh * d
    out["paged_prefill_gqa"] = dict(
        ms=ms, plain_ms=plain_ms, library_ms=lib_ms, max_abs_err=err,
        max_abs_err_fp32=err32, bytes=nbytes, flops=flops,
        shape=f"B=1 S={S} start={start}")
    del kp, vp
    for name, r in out.items():
        t_bytes = r["bytes"] / H100_BYTES_PER_S * 1e3
        t_ops = r["flops"] / H100_FLOPS["bfloat16"] * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        _log("timing", kernel=name, shape=repr(r["shape"]), ms=r["ms"],
             plain_ms=r["plain_ms"], library_ms=r["library_ms"],
             bound_ms=r["bound_ms"], bound_by=r["bound_by"],
             max_abs_err=r["max_abs_err"],
             max_abs_err_fp32=r["max_abs_err_fp32"], dtype="bfloat16")
    return out


# ---------------------------------------------------------------------------
# engine parity in fp32 (full width, 2 layers)
# ---------------------------------------------------------------------------

def _margins_ok(model, prompt, out, device, min_margin=1e-3) -> bool:
    """Top-2 logit margin of every generated position under teacher forcing
    (the full-sequence forward without a cache)."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as T
    seq = np.concatenate([prompt, out[:-1]]).astype(np.int64)
    with torch.no_grad():
        lg = T.logits(model, torch.from_numpy(seq)[None].to(device))[0]
    lg = lg[len(prompt) - 1:].float()
    top2 = lg.topk(2, dim=-1).values
    return bool(((top2[:, 0] - top2[:, 1]) >= min_margin).all())


def parity(cfg, device="cuda", block_size=16, chunk=64) -> dict:
    import numpy as np
    import torch
    from repro_torch.kernels.paged_attention import kernel as K1
    from repro_torch.kernels.paged_attention import prefill as K2
    from repro_torch.models import transformer as T
    from repro_torch.serving import ContinuousEngine, Request, ServingEngine
    model = T.init(cfg, torch.Generator(device=device).manual_seed(SEED),
                   device=device, dtype=torch.float32)
    rng = np.random.default_rng(SEED + 1)
    V = cfg.vocab_size
    sys_p = rng.integers(3, V, size=block_size * 2 + 5)  # ends mid-block
    prompts = [np.concatenate([sys_p, rng.integers(3, V, size=n)])
               for n in (7, 30, 3, 61)]
    prompts.append(prompts[1].copy())                     # exact duplicate
    prompts.append(rng.integers(3, V, size=90))
    prompts = [p.astype(np.int32) for p in prompts]
    max_new = [6, 9, 4, 8, 5, 7]
    k1, k2 = K1.paged_decode_gqa.launches, K2.paged_prefill_gqa.launches
    eng = ContinuousEngine(cfg, model, max_batch=3, block_size=block_size,
                           num_blocks=128, max_len=256, prefill_chunk=chunk,
                           device=device)
    reqs = [Request(prompt=p, max_new=m) for p, m in zip(prompts, max_new)]
    eng.serve(reqs)
    oracle = ServingEngine(cfg, model, max_batch=1, max_len=256,
                           device=device)
    oreqs = [Request(prompt=p, max_new=m) for p, m in zip(prompts, max_new)]
    oracle.serve(oreqs)
    compared = skipped = 0
    for r, o in zip(reqs, oreqs):
        if not _margins_ok(model, r.prompt, o.out, device):
            skipped += 1
            continue
        compared += 1
        if not np.array_equal(r.out, o.out):
            raise AssertionError(f"parity: engine {r.out.tolist()} != "
                                 f"oracle {o.out.tolist()}")
    if compared == 0:
        raise AssertionError("parity: no prompt had a top-2 margin")
    st = eng.stats
    if st["cached_tokens"] <= 0 or st["cow_forks"] <= 0 \
            or not any(s > 0 for s in st["admit_steps"]):
        raise AssertionError(f"parity: workload missed radix/COW/mid-flight "
                             f"admission: {dict(st)}")
    if K1.paged_decode_gqa.launches == k1 and device != "cpu":
        raise AssertionError("parity: K1 never launched")
    if K2.paged_prefill_gqa.launches == k2 and device != "cpu":
        raise AssertionError("parity: K2 never launched")
    res = dict(compared=compared, skipped=skipped,
               cached_tokens=st["cached_tokens"], cow_forks=st["cow_forks"],
               chunk_steps=st["chunk_steps"])
    _log("parity", layers=cfg.num_layers, d_model=cfg.d_model,
         dtype="float32", **res)
    del eng, oracle, model
    return res


# ---------------------------------------------------------------------------
# serve at full width and depth in bf16
# ---------------------------------------------------------------------------

def serve(cfg, prompt_lens, device="cuda", block_size=16, num_blocks=2048,
          chunk=256, max_new=32, shared=200) -> dict:
    import numpy as np
    import torch
    from repro_torch.kernels.paged_attention import kernel as K1
    from repro_torch.kernels.paged_attention import prefill as K2
    from repro_torch.models import transformer as T
    from repro_torch.serving import ContinuousEngine, Request
    t0 = time.perf_counter()
    model = T.init(cfg, torch.Generator(device=device).manual_seed(SEED),
                   device=device, dtype=torch.bfloat16)
    n_params = sum(p.numel() for p in model.parameters())
    eng = ContinuousEngine(cfg, model, max_batch=8, block_size=block_size,
                           num_blocks=num_blocks,
                           max_len=max(prompt_lens) + max_new + chunk,
                           prefill_chunk=chunk, device=device)
    pool_gib = sum(x.numel() * x.element_size() for lv in eng.pool.values()
                   for x in lv.values()) / 2 ** 30
    rng = np.random.default_rng(SEED + 2)
    V = cfg.vocab_size
    sys_p = rng.integers(3, V, size=shared)
    prompts = []
    for i, n in enumerate(prompt_lens):
        if i % 2 == 0 and n > shared:     # half share the system prefix
            p = np.concatenate([sys_p, rng.integers(3, V, size=n - shared)])
        else:
            p = rng.integers(3, V, size=n)
        prompts.append(p.astype(np.int32))
    # warm-up, not measured: the system prompt alone, as earlier traffic
    # would have left it in the radix cache (also warms cuBLAS/allocator)
    eng.serve([Request(prompt=sys_p.astype(np.int32), max_new=4)])
    setup_s = time.perf_counter() - t0
    eng.stats = {}
    eng.registry.reset_histograms("engine")
    reqs = [Request(prompt=p, max_new=max_new) for p in prompts]
    K1.paged_decode_gqa.launches = 0           # counts of the main path
    K2.paged_prefill_gqa.launches = 0
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    decode_s, decode_toks = 0.0, 0
    while eng.busy:
        before = (eng.stats["prefills"], eng.stats["chunk_steps"],
                  eng.stats["decode_tokens"])
        ts = time.perf_counter()
        eng.step()                 # ends with logits on the host: synced
        dt = time.perf_counter() - ts
        if (eng.stats["prefills"], eng.stats["chunk_steps"]) == before[:2]:
            decode_s += dt         # a step with no prefill work
            decode_toks += eng.stats["decode_tokens"] - before[2]
    wall = time.perf_counter() - t0
    launches = {"paged_decode_gqa": K1.paged_decode_gqa.launches,
                "paged_prefill_gqa": K2.paged_prefill_gqa.launches}
    for r in reqs:
        if r.status != "ok" or r.out is None or len(r.out) != max_new:
            raise AssertionError(f"serve: request {r.rid} ended "
                                 f"{r.status} ({r.error!r})")
        if not ((r.out >= 0) & (r.out < V)).all():
            raise AssertionError(f"serve: token out of range in {r.rid}")
    for lv in eng.pool.values():
        for x in lv.values():
            if not torch.isfinite(x).all():
                raise AssertionError("serve: non-finite value in the pool")
    if device != "cpu" and (launches["paged_decode_gqa"] == 0
                            or launches["paged_prefill_gqa"] == 0):
        raise AssertionError(f"serve: a kernel never launched: {launches}")
    st = eng.stats
    lat = eng.latency_summary()
    res = dict(
        params_b=n_params / 1e9, pool_gib=pool_gib, requests=len(reqs),
        prompt_tokens=int(sum(prompt_lens)),
        cached_tokens=st["cached_tokens"],
        decode_tokens=st["decode_tokens"], decode_steps=st["decode_steps"],
        wall_s=wall, setup_s=setup_s,
        decode_tok_s=decode_toks / decode_s if decode_s else 0.0,
        decode_only_steps_s=decode_s,
        ttft_p50_ms=lat["ttft_ms"]["p50"], tpot_p50_ms=lat["tpot_ms"]["p50"],
        k1_launches=launches["paged_decode_gqa"],
        k2_launches=launches["paged_prefill_gqa"],
        k1_per_step=launches["paged_decode_gqa"] / max(st["decode_steps"], 1),
        k2_per_span=launches["paged_prefill_gqa"] / max(
            st["chunk_steps"], 1))
    _log("serve", layers=cfg.num_layers, d_model=cfg.d_model,
         dtype="bfloat16", **res)
    res["launches"] = launches
    return res


def profile_decode(cfg, device="cuda", steps=8, block_size=16,
                   num_blocks=2048) -> dict:
    """``steps`` decode-only steps of 8 rows at ~530 live tokens each,
    timed without and then with torch.profiler; the device busy share
    (kernel time over the profiled window's wall time) and the top kernels
    by device time."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer as T
    from repro_torch.serving import ContinuousEngine, Request
    model = T.init(cfg, torch.Generator(device=device).manual_seed(SEED),
                   device=device, dtype=torch.bfloat16)
    eng = ContinuousEngine(cfg, model, max_batch=8, block_size=block_size,
                           num_blocks=num_blocks, max_len=1024,
                           prefill_chunk=256, device=device)
    rng = np.random.default_rng(SEED + 3)
    for _ in range(8):
        eng.submit(Request(prompt=rng.integers(3, cfg.vocab_size, size=512)
                           .astype(np.int32), max_new=2 * steps + 12))
    while any(s is None or s.pending is None for s in eng.slots):
        eng.step()                          # admit + prefill everything
    for _ in range(2):
        eng.step()                          # warm decode
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()                          # the same window, unprofiled
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only: a CPU op's device time repeats its kernels'
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) \
            or getattr(e, "self_cuda_time_total", 0.0)
    busy_us = sum(dev_us(e) for e in kernels)
    res = dict(step_ms=plain_wall / steps * 1e3,
               profiled_step_ms=wall / steps * 1e3,
               device_busy_ms_per_step=busy_us / steps / 1e3,
               device_busy_share=busy_us / 1e6 / wall,
               kernel_launches_per_step=sum(e.count for e in kernels) / steps)
    _log("profile", **res)
    for e in sorted(kernels, key=dev_us, reverse=True)[:8]:
        _log("profile.kernel", name=repr(e.key[:60]),
             device_ms_per_step=dev_us(e) / steps / 1e3,
             calls_per_step=e.count / steps)
    return res


# ---------------------------------------------------------------------------

def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: the port's package is missing under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.kernels import build

    _log("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=repr(torch.cuda.get_device_name(0)),
         count=torch.cuda.device_count())
    t0 = time.perf_counter()
    lib = build.build("paged_attention")
    build.load("paged_attention")
    _log("build", seconds=time.perf_counter() - t0, library=lib.name)

    worst = check_kernels()
    yi = get_config("yi_6b").replace(dsa=None)
    prompt_lens = [1024, 32, 777, 150, 512, 64, 900, 300]
    timing = time_kernels(yi, [n + 16 for n in prompt_lens],
                          max(prompt_lens), bs=16, num_blocks=2048, chunk=256)
    torch.cuda.empty_cache()
    parity(yi.replace(num_layers=2))
    torch.cuda.empty_cache()
    res = serve(yi, prompt_lens)
    torch.cuda.empty_cache()
    profile_decode(yi)

    source = "src/repro_torch/csrc/paged_attention.cu"
    replaces = {"paged_decode_gqa":
                "src/repro/kernels/paged_attention/kernel.py:109",
                "paged_prefill_gqa":
                "src/repro/kernels/paged_attention/prefill.py:112"}
    kernels = []
    for name in ("paged_decode_gqa", "paged_prefill_gqa"):
        t = timing[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces[name],
            launches=res["launches"][name],
            max_abs_err=max(t["max_abs_err"], worst[name]),
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else f"nvidia-smi failed: {smi.stderr.strip()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
