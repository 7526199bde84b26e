"""K1, K3 and K5: paged decode kernels, hand-written for Hopper, and their
plain versions.

K1 ``paged_decode_gqa`` ports ``repro.kernels.paged_attention.kernel.
paged_decode_gqa`` (GQA); K3 ``paged_decode_mla`` ports ``paged_decode_mla``
(absorbed MLA over the latent pools); K5 ``paged_indexer_scores_kernel``
ports ``paged_indexer_scores_kernel`` (DSA lightning-indexer scores over the
``k_idx`` pool).  The CUDA kernels are in ``csrc/paged_attention.cu`` (K1,
K2), ``csrc/paged_mla.cu`` (K3, K4) and ``csrc/paged_indexer.cu`` (K5, K6),
built by ``repro_torch.kernels.build``: K1's bf16 body, K3's bf16 tile and
K5's bf16 decode body at 8, 16 or 32 indexer heads run on the tensor cores
(``mma.sync``), the fp32 routes (the exact parity runs) on the CUDA cores.
``*_plain`` is the same function in plain PyTorch — the counterpart of
the reference's XLA twins ``ops._blocked_gqa`` / ``_blocked_mla`` /
``_blocked_indexer``: a loop over live blocks with the same masks and
arithmetic (the attention kernels' fp32 online softmax).

Addressing contract (as the reference): position ``p`` of row ``b`` lives
at ``(tables[b, p // bs], p % bs)``; ``seq_lens[b]`` is the query's
position (its K/V were scattered before the call) and attention covers
positions ``<= seq_lens[b]``; idle slots point at the trash block with
length 0 and still get a finite output.

Each wrapper chooses by the tensors' device: on the CPU or meta it runs the plain
version, on a CUDA device it launches the kernel or raises.  There is no
fallback.  ``<wrapper>.launches`` counts kernel launches.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.build import DTYPE_CODE as _DTYPE_CODE
from repro_torch.kernels.build import check_launch as _check_launch
from repro_torch.kernels.build import count_launch, cuda_entry, refuse_dtensor
from repro_torch.kernels.build import resources as _resources

NEG_INF = -1e30
HEAD_DIMS = (64, 80, 96, 128, 256)
MLA_DIMS = ((512, 64),)          # (kv_lora, rope) the MLA kernels take
INDEX_DIMS = (16, 32, 64, 128)   # indexer head dims the K5/K6 kernels take
INDEX_WIDTH = 8192               # max Hi*Di: a token's fp32 queries, 32 KB
BLOCK_SIZES = (8, 16, 32)


def check_cuda_args(q, k_pool, v_pool, block_tables, positions) -> None:
    """Raise on anything the CUDA kernels do not take.  Called on every
    decode and prefill launch, so each tensor attribute is read once (the
    wrapper's host work sets K1's time at the decode step)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"paged attention kernel runs on CUDA tensors, got "
                         f"{dev}")
    if k_pool.device != dev or v_pool.device != dev \
            or block_tables.device != dev or positions.device != dev:
        raise ValueError("paged attention: all tensors must be on one device")
    dtype = q.dtype
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"paged attention kernel takes float32 or bfloat16, "
                        f"got {dtype}")
    if k_pool.dtype != dtype or v_pool.dtype != dtype:
        raise TypeError("paged attention: q and the pools must share a dtype")
    if block_tables.dtype != torch.int32 or positions.dtype != torch.int32:
        raise TypeError("paged attention: tables and positions must be int32")
    if not (q.is_contiguous() and k_pool.is_contiguous()
            and v_pool.is_contiguous() and block_tables.is_contiguous()
            and positions.is_contiguous()):
        raise ValueError("paged attention kernel needs contiguous tensors")
    if (q.data_ptr() | k_pool.data_ptr() | v_pool.data_ptr()) % 16:
        raise ValueError("paged attention kernel needs 16-byte aligned "
                         "tensors")
    qs, ks = q.shape, k_pool.shape
    d, bs = qs[-1], ks[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"paged attention kernel: head_dim {d} not in "
                         f"{HEAD_DIMS}")
    if bs not in BLOCK_SIZES:
        raise ValueError(f"paged attention kernel: block size {bs} not in "
                         f"{BLOCK_SIZES}")
    if ks != v_pool.shape or ks[-1] != d or ks[2] != qs[1]:
        raise ValueError(f"paged attention: pools {tuple(ks)} do not match "
                         f"q {tuple(qs)}")
    if block_tables.shape[0] != qs[0] or positions.shape != (qs[0],):
        raise ValueError("paged attention: tables/positions batch mismatch")


def paged_decode_gqa_plain(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           seq_lens: torch.Tensor, *, window: int = 0,
                           softcap: float = 0.0) -> torch.Tensor:
    """Plain PyTorch K1: q (B, KVH, G, d); pools (nb, bs, KVH, d); tables
    (B, mb); seq_lens (B,) -> (B, KVH, G, d) in q.dtype.  Folds the blocks
    up to the batch's longest row one at a time (fp32 online softmax)."""
    B, KVH, G, d = q.shape
    bs = k_pool.shape[1]
    scale = d ** -0.5
    qf = q.float()
    lens = seq_lens.long()
    n_live = int(lens.max()) // bs + 1
    m = torch.full((B, KVH, G), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, KVH, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KVH, G, d), dtype=torch.float32, device=q.device)
    offs = torch.arange(bs, device=q.device)
    for j in range(n_live):
        blk = block_tables[:, j].long()
        kb = k_pool[blk].float()                       # (B, bs, KVH, d)
        vb = v_pool[blk].float()
        s = torch.einsum("bkgd,btkd->bkgt", qf, kb) * scale
        if softcap > 0:
            s = softcap * torch.tanh(s / softcap)
        k_pos = j * bs + offs
        mask = k_pos[None, :] <= lens[:, None]
        if window > 0:
            mask &= (lens[:, None] - k_pos[None, :]) < window
        mask = mask[:, None, None, :]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]),
                        torch.zeros_like(s))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgt,btkd->bkgd", p, vb)
        m = m_new
    return (acc / l.clamp_min(1e-20)[..., None]).to(q.dtype)


MAX_DECODE_PARTS = 16     # runs of blocks K1 cuts a row's live range into
DECODE_ROWS = 8           # query rows a CTA of K1


def decode_workspace(B: int, KVH: int, G: int, d: int, parts: int) -> int:
    """fp32 floats of K1's combine workspace: each run's (m, l, acc) of a
    CTA's rows, for every (batch row, kv head, row tile)."""
    return B * KVH * -(-G // DECODE_ROWS) * parts * DECODE_ROWS * (d + 2)


@functools.lru_cache(maxsize=None)
def decode_parts(dtype_code: int, d: int, bs: int, B: int, KVH: int, G: int,
                 mb: int, index: int) -> tuple:
    """The key-range split of K1's launch, from the shapes alone (never
    ``seq_lens``, which would cost a device-to-host copy): (parts,
    workspace floats).  As many runs of blocks a (kv head, batch row, 8
    query rows) as one wave of every CTA slot of the card holds (the CTAs
    an SM from K1's occupancy query, times the SMs), at most
    ``MAX_DECODE_PARTS`` and at most ``mb`` (one block a run); the combine
    pass's workspace holds each run's (m, l, acc) of 8 rows."""
    *_, per_sm, rows = _resources("paged_decode_gqa_resources", dtype_code,
                                  d, bs)
    if rows != DECODE_ROWS:
        raise RuntimeError(f"K1's library takes {rows} rows a CTA, the "
                           f"wrapper {DECODE_ROWS}: a stale build")
    tiles = B * KVH * -(-G // DECODE_ROWS)
    slots = per_sm * torch.cuda.get_device_properties(index) \
        .multi_processor_count
    parts = max(1, min(MAX_DECODE_PARTS, mb, slots // tiles))
    return parts, decode_workspace(B, KVH, G, d, parts)


def _launch(q, k_pool, v_pool, block_tables, seq_lens, window, softcap,
            code, B, KVH, G, d, parts, ws_floats, index) -> torch.Tensor:
    # the raw stream handle, as Triton's launcher reads it: Stream objects
    # cost microseconds, and K1's time at the decode step is host work
    out = torch.empty_like(q)
    ws = None if parts == 1 else q.new_empty(ws_floats, dtype=torch.float32)
    err = cuda_entry("paged_decode_gqa")(
        code, d, k_pool.shape[1], q.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), block_tables.data_ptr(), seq_lens.data_ptr(),
        out.data_ptr(), B, KVH, G, block_tables.shape[1], window, softcap,
        d ** -0.5, parts, None if ws is None else ws.data_ptr(),
        torch._C._cuda_getCurrentRawStream(index))
    _check_launch("paged_decode_gqa", err)
    return out


def launch_decode_gqa(q: torch.Tensor, k_pool: torch.Tensor,
                      v_pool: torch.Tensor, block_tables: torch.Tensor,
                      seq_lens: torch.Tensor, window: int, softcap: float,
                      parts: int) -> torch.Tensor:
    """K1's C entry point on checked CUDA tensors with the live range cut
    into ``parts`` runs (1..16; the workspace of the combine pass from
    PyTorch's caching allocator) -> out.  Counts nothing: the wrapper does,
    and the tests call this to force ``parts``."""
    B, KVH, G, d = q.shape
    return _launch(q, k_pool, v_pool, block_tables, seq_lens, window,
                   softcap, _DTYPE_CODE[q.dtype], B, KVH, G, d, parts,
                   decode_workspace(B, KVH, G, d, parts), q.get_device())


def paged_decode_gqa(q: torch.Tensor, k_pool: torch.Tensor,
                     v_pool: torch.Tensor, block_tables: torch.Tensor,
                     seq_lens: torch.Tensor, *, window: int = 0,
                     softcap: float = 0.0) -> torch.Tensor:
    """K1: q (B, KVH, G, d); k/v pools (nb, bs, KVH, d); tables (B, mb)
    int32; seq_lens (B,) int32 -> (B, KVH, G, d) in q.dtype.

    CPU and meta tensors run ``paged_decode_gqa_plain``; CUDA tensors launch the
    Hopper kernel on the current stream: split-KV, a CTA per (kv head,
    batch row, run of blocks), ``decode_parts`` runs, and a combine pass
    where there is more than one (one launch on the count)."""
    refuse_dtensor("paged_decode_gqa", q, k_pool, v_pool, block_tables,
                   seq_lens)
    if q.device.type in ("cpu", "meta"):
        return paged_decode_gqa_plain(q, k_pool, v_pool, block_tables,
                                      seq_lens, window=window,
                                      softcap=softcap)
    check_cuda_args(q, k_pool, v_pool, block_tables, seq_lens)
    B, KVH, G, d = q.shape
    code, index = _DTYPE_CODE[q.dtype], q.get_device()
    parts, ws_floats = decode_parts(code, d, k_pool.shape[1], B, KVH, G,
                                    block_tables.shape[1], index)
    out = _launch(q, k_pool, v_pool, block_tables, seq_lens, window, softcap,
                  code, B, KVH, G, d, parts, ws_floats, index)
    count_launch(paged_decode_gqa)
    return out


paged_decode_gqa.launches = 0


# ---------------------------------------------------------------------------
# K3: absorbed MLA decode over the latent pools
# ---------------------------------------------------------------------------

def check_cuda_mla_args(q_lat, q_rope, c_pool, kr_pool, block_tables,
                        positions) -> None:
    """Raise on anything the CUDA MLA kernels (K3, K4) do not take.  q_lat
    (B, R, lora) fp32; q_rope (B, R, rope) in the pools' dtype; pools
    (nb, bs, ·).  Called on every launch, so each tensor attribute is read
    once and what depends on dtypes and shapes alone is checked once a
    combination (``_mla_shapes``); the device, contiguity and alignment
    are checked every call."""
    dev = q_lat.device
    if dev.type != "cuda":
        raise ValueError(f"paged MLA kernel runs on CUDA tensors, got {dev}")
    if q_rope.device != dev or c_pool.device != dev \
            or kr_pool.device != dev or block_tables.device != dev \
            or positions.device != dev:
        raise ValueError("paged MLA: all tensors must be on one device")
    _mla_shapes(q_lat.dtype, q_rope.dtype, c_pool.dtype, kr_pool.dtype,
                block_tables.dtype, positions.dtype, q_lat.shape,
                q_rope.shape, c_pool.shape, kr_pool.shape,
                block_tables.shape, positions.shape)
    if not (q_lat.is_contiguous() and q_rope.is_contiguous()
            and c_pool.is_contiguous() and kr_pool.is_contiguous()
            and block_tables.is_contiguous() and positions.is_contiguous()):
        raise ValueError("paged MLA kernel needs contiguous tensors")
    if (q_lat.data_ptr() | q_rope.data_ptr() | c_pool.data_ptr()
            | kr_pool.data_ptr()) % 16:
        raise ValueError("paged MLA kernel needs 16-byte aligned tensors")


@functools.lru_cache(maxsize=None)
def _mla_shapes(ql_dtype, qr_dtype, c_dtype, kr_dtype, t_dtype, p_dtype,
                ql_shape, qr_shape, c_shape, kr_shape, t_shape,
                p_shape) -> None:
    """The dtype and shape half of ``check_cuda_mla_args``; a combination
    that passes is remembered, one that raises is not."""
    if ql_dtype != torch.float32:
        raise TypeError(f"paged MLA: q_lat must be float32 (the absorbed "
                        f"query is built in fp32), got {ql_dtype}")
    if c_dtype not in _DTYPE_CODE:
        raise TypeError(f"paged MLA kernel takes float32 or bfloat16 pools, "
                        f"got {c_dtype}")
    if qr_dtype != c_dtype or kr_dtype != c_dtype:
        raise TypeError("paged MLA: q_rope and the pools must share a dtype")
    if t_dtype != torch.int32 or p_dtype != torch.int32:
        raise TypeError("paged MLA: tables and positions must be int32")
    L, R = ql_shape[-1], qr_shape[-1]
    if (L, R) not in MLA_DIMS:
        raise ValueError(f"paged MLA kernel: (kv_lora, rope) {(L, R)} not "
                         f"in {MLA_DIMS}")
    if c_shape[1] not in BLOCK_SIZES:
        raise ValueError(f"paged MLA kernel: block size {c_shape[1]} not in "
                         f"{BLOCK_SIZES}")
    if c_shape[:2] != kr_shape[:2] or c_shape[-1] != L \
            or kr_shape[-1] != R or qr_shape[:2] != ql_shape[:2]:
        raise ValueError(f"paged MLA: pools {tuple(c_shape)}, "
                         f"{tuple(kr_shape)} do not match q "
                         f"{tuple(ql_shape)}, {tuple(qr_shape)}")
    if t_shape[0] != ql_shape[0] or p_shape != (ql_shape[0],):
        raise ValueError("paged MLA: tables/positions batch mismatch")


def mla_fold_blocks(q_lat: torch.Tensor, q_rope: torch.Tensor,
                    c_pool: torch.Tensor, kr_pool: torch.Tensor,
                    block_tables: torch.Tensor, q_pos: torch.Tensor,
                    n_live: int, scale: float) -> torch.Tensor:
    """The plain MLA fold shared by K3 and K4: q_lat (B, R, lora), q_rope
    (B, R, rope), q_pos (B, R) each row's position; the first ``n_live``
    blocks of every row folded with an fp32 online softmax -> (B, R, lora)
    fp32, ``probs · c``."""
    B, Rn, L = q_lat.shape
    bs = c_pool.shape[1]
    ql, qr = q_lat.float(), q_rope.float()
    m = torch.full((B, Rn), NEG_INF, dtype=torch.float32,
                   device=q_lat.device)
    l = torch.zeros((B, Rn), dtype=torch.float32, device=q_lat.device)
    acc = torch.zeros((B, Rn, L), dtype=torch.float32, device=q_lat.device)
    offs = torch.arange(bs, device=q_lat.device)
    for j in range(n_live):
        blk = block_tables[:, j].long()
        cb = c_pool[blk].float()                       # (B, bs, lora)
        krb = kr_pool[blk].float()
        s = (torch.einsum("brl,btl->brt", ql, cb)
             + torch.einsum("brk,btk->brt", qr, krb)) * scale
        k_pos = j * bs + offs
        mask = k_pos[None, None, :] <= q_pos[:, :, None]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]),
                        torch.zeros_like(s))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("brt,btl->brl", p, cb)
        m = m_new
    return acc / l.clamp_min(1e-20)[..., None]


def paged_decode_mla_plain(q_lat: torch.Tensor, q_rope: torch.Tensor,
                           c_pool: torch.Tensor, kr_pool: torch.Tensor,
                           block_tables: torch.Tensor,
                           seq_lens: torch.Tensor, *,
                           scale: float) -> torch.Tensor:
    """Plain PyTorch K3 (counterpart of the reference's ``ops._blocked_mla``):
    q_lat (B, H, lora); q_rope (B, H, rope); pools (nb, bs, ·) -> (B, H,
    lora) fp32, folding blocks up to the batch's longest row."""
    lens = seq_lens.long()
    n_live = int(lens.max()) // c_pool.shape[1] + 1
    q_pos = lens[:, None].expand(q_lat.shape[:2])
    return mla_fold_blocks(q_lat, q_rope, c_pool, kr_pool, block_tables,
                           q_pos, n_live, scale)


MAX_MLA_DECODE_PARTS = 16   # key-range parts K3's combine pass folds
MLA_ROWS = 64               # heads a CTA of K3's bf16 tile


def mla_decode_workspace(B: int, H: int, L: int, parts: int) -> int:
    """fp32 floats of K3's combine workspace: each part's (m, l, acc) of
    every row of every (batch row, 64-head tile)."""
    return B * -(-H // MLA_ROWS) * parts * MLA_ROWS * (L + 2)


@functools.lru_cache(maxsize=None)
def mla_decode_parts(B: int, H: int, L: int, R: int, mb: int,
                     index: int) -> tuple:
    """The key-range split of K3's bf16 launch, from the shapes alone
    (never ``seq_lens``, which would cost a device-to-host copy): (parts,
    workspace floats).  As many parts a (batch row, 64-head tile) as one
    wave of every CTA slot of the card holds (the CTAs an SM of the tile's
    occupancy query, times the SMs), at most ``MAX_MLA_DECODE_PARTS`` and
    at most ``mb`` (a block a part)."""
    *_, per_sm, rows = _resources("paged_mla_resources", 1, L, R)
    if rows != MLA_ROWS:
        raise RuntimeError(f"K3's library takes {rows} rows a CTA, the "
                           f"wrapper {MLA_ROWS}: a stale build")
    tiles = B * -(-H // MLA_ROWS)
    slots = per_sm * torch.cuda.get_device_properties(index) \
        .multi_processor_count
    parts = max(1, min(MAX_MLA_DECODE_PARTS, mb, slots // tiles))
    return parts, mla_decode_workspace(B, H, L, parts)


def _launch_mla(q_lat, q_rope, c_pool, kr_pool, block_tables, seq_lens,
                scale, parts, ws_floats, index) -> torch.Tensor:
    B, H, L = q_lat.shape
    out = torch.empty_like(q_lat)
    ws = None if parts == 1 else q_lat.new_empty(ws_floats)
    err = cuda_entry("paged_decode_mla")(
        _DTYPE_CODE[c_pool.dtype], L, q_rope.shape[-1], c_pool.shape[1],
        q_lat.data_ptr(), q_rope.data_ptr(), c_pool.data_ptr(),
        kr_pool.data_ptr(), block_tables.data_ptr(), seq_lens.data_ptr(),
        out.data_ptr(), B, H, block_tables.shape[1], scale, parts,
        None if ws is None else ws.data_ptr(),
        torch._C._cuda_getCurrentRawStream(index))
    _check_launch("paged_decode_mla", err)
    return out


def launch_decode_mla(q_lat: torch.Tensor, q_rope: torch.Tensor,
                      c_pool: torch.Tensor, kr_pool: torch.Tensor,
                      block_tables: torch.Tensor, seq_lens: torch.Tensor,
                      scale: float, parts: int) -> torch.Tensor:
    """K3's C entry point on checked CUDA tensors with each row's key
    rounds split into ``parts`` CTAs (bf16: 1..16; fp32: 1; the workspace
    of the combine pass from PyTorch's caching allocator) -> out.  Counts
    nothing: the wrapper does, and the tests call this to force
    ``parts``."""
    B, H, L = q_lat.shape
    return _launch_mla(q_lat, q_rope, c_pool, kr_pool, block_tables,
                       seq_lens, scale, parts,
                       mla_decode_workspace(B, H, L, parts),
                       q_lat.get_device())


def paged_decode_mla(q_lat: torch.Tensor, q_rope: torch.Tensor,
                     c_pool: torch.Tensor, kr_pool: torch.Tensor,
                     block_tables: torch.Tensor, seq_lens: torch.Tensor, *,
                     scale: float) -> torch.Tensor:
    """K3: q_lat (B, H, lora) fp32 = q_nope·W^UK; q_rope (B, H, rope);
    c_pool (nb, bs, lora); kr_pool (nb, bs, rope); tables (B, mb) int32;
    seq_lens (B,) int32 -> out_lat (B, H, lora) fp32 (``probs · c``; the
    caller applies W^UV and W^O).  ``scale`` is (qk_nope + qk_rope)^-1/2.

    CPU and meta tensors run ``paged_decode_mla_plain``; CUDA tensors launch the
    Hopper kernel on the current stream: bf16 pools the tensor-core tile,
    a CTA per (64-head tile, batch row, part of the row's key rounds),
    ``mla_decode_parts`` parts, and a combine pass where there is more
    than one (one launch on the count); fp32 pools the SIMT body."""
    refuse_dtensor("paged_decode_mla", q_lat, q_rope, c_pool, kr_pool,
                   block_tables, seq_lens)
    if q_lat.device.type in ("cpu", "meta"):
        return paged_decode_mla_plain(q_lat, q_rope, c_pool, kr_pool,
                                      block_tables, seq_lens, scale=scale)
    check_cuda_mla_args(q_lat, q_rope, c_pool, kr_pool, block_tables,
                        seq_lens)
    index = q_lat.get_device()
    parts, ws_floats = 1, 0
    if c_pool.dtype == torch.bfloat16:
        B, H, L = q_lat.shape
        parts, ws_floats = mla_decode_parts(B, H, L, q_rope.shape[-1],
                                            block_tables.shape[1], index)
    out = _launch_mla(q_lat, q_rope, c_pool, kr_pool, block_tables,
                      seq_lens, scale, parts, ws_floats, index)
    count_launch(paged_decode_mla)
    return out


paged_decode_mla.launches = 0


# ---------------------------------------------------------------------------
# K5: DSA lightning-indexer decode scores over the k_idx pool
# ---------------------------------------------------------------------------

def check_cuda_indexer_args(q_idx, w_head, k_pool, block_tables,
                            positions, heads: int) -> None:
    """Raise on anything the CUDA indexer kernels (K5, K6) do not take.
    q_idx (B, R, Di) in the pool's dtype, R a multiple of ``heads``;
    w_head (B, R) fp32; k_pool (nb, bs, Di).  Called on every launch, so
    each tensor attribute is read once and what depends on dtypes and
    shapes alone is checked once a combination (``_indexer_shapes``); the
    device, contiguity and alignment are checked every call."""
    dev = q_idx.device
    if dev.type != "cuda":
        raise ValueError(f"paged indexer kernel runs on CUDA tensors, got "
                         f"{dev}")
    if w_head.device != dev or k_pool.device != dev \
            or block_tables.device != dev or positions.device != dev:
        raise ValueError("paged indexer: all tensors must be on one device")
    _indexer_shapes(q_idx.dtype, w_head.dtype, k_pool.dtype,
                    block_tables.dtype, positions.dtype, q_idx.shape,
                    w_head.shape, k_pool.shape, block_tables.shape,
                    positions.shape, heads)
    if not (q_idx.is_contiguous() and w_head.is_contiguous()
            and k_pool.is_contiguous() and block_tables.is_contiguous()
            and positions.is_contiguous()):
        raise ValueError("paged indexer kernel needs contiguous tensors")
    if (q_idx.data_ptr() | k_pool.data_ptr()) % 16:
        raise ValueError("paged indexer kernel needs 16-byte aligned q_idx "
                         "and pool")


@functools.lru_cache(maxsize=None)
def _indexer_shapes(q_dtype, w_dtype, k_dtype, t_dtype, p_dtype, q_shape,
                    w_shape, k_shape, t_shape, p_shape, heads) -> None:
    """The dtype and shape half of ``check_cuda_indexer_args``; a
    combination that passes is remembered, one that raises is not."""
    if q_dtype not in _DTYPE_CODE:
        raise TypeError(f"paged indexer kernel takes float32 or bfloat16, "
                        f"got {q_dtype}")
    if k_dtype != q_dtype:
        raise TypeError("paged indexer: q_idx and the pool must share a "
                        "dtype")
    if w_dtype != torch.float32:
        raise TypeError(f"paged indexer: head weights must be float32, got "
                        f"{w_dtype}")
    if t_dtype != torch.int32 or p_dtype != torch.int32:
        raise TypeError("paged indexer: tables and positions must be int32")
    Di = q_shape[-1]
    if Di not in INDEX_DIMS:
        raise ValueError(f"paged indexer kernel: index_head_dim {Di} not in "
                         f"{INDEX_DIMS}")
    if q_shape[1] % heads or heads * Di > INDEX_WIDTH:
        raise ValueError(f"paged indexer kernel: {q_shape[1]} rows of "
                         f"{heads} heads x {Di} (at most {INDEX_WIDTH})")
    if len(k_shape) != 3 or k_shape[-1] != Di:
        raise ValueError(f"paged indexer: pool {tuple(k_shape)} does not "
                         f"match q_idx {tuple(q_shape)}")
    if w_shape != q_shape[:2]:
        raise ValueError(f"paged indexer: weights {tuple(w_shape)} do not "
                         f"match q_idx {tuple(q_shape)}")
    if t_shape[0] != q_shape[0] or p_shape != (q_shape[0],):
        raise ValueError("paged indexer: tables/positions batch mismatch")


def indexer_fold_blocks(q_idx: torch.Tensor, w_head: torch.Tensor,
                        k_pool: torch.Tensor, block_tables: torch.Tensor,
                        last: torch.Tensor) -> torch.Tensor:
    """The plain indexer loop shared by K5 and K6: q_idx (B, S, Hi, Di),
    w_head (B, S, Hi), ``last`` (B,) each row's last query position ->
    scores (B, S, mb*bs) fp32 in view coordinates: relu(q·k)·Di^-1/2
    summed over heads with the weights, for every position of a block that
    starts at or before ``last[b]`` (the whole block, as the Pallas kernels
    give it); NEG_INF in every other block."""
    B, S, Hi, Di = q_idx.shape
    bs, mb = k_pool.shape[1], block_tables.shape[1]
    scale = Di ** -0.5
    qf, wf = q_idx.float(), w_head.float()
    last = last.long()
    out = torch.full((B, S, mb * bs), NEG_INF, dtype=torch.float32,
                     device=q_idx.device)
    for j in range(min(int(last.max()) // bs + 1, mb)):
        kb = k_pool[block_tables[:, j].long()].float()     # (B, bs, Di)
        dots = torch.relu(torch.einsum("bshd,btd->bsht", qf, kb)) * scale
        s = torch.einsum("bsht,bsh->bst", dots, wf)
        dead = (j * bs > last)[:, None, None]
        out[:, :, j * bs:(j + 1) * bs] = s.masked_fill(dead, NEG_INF)
    return out


def paged_indexer_scores_plain(q_idx: torch.Tensor, w_head: torch.Tensor,
                               k_pool: torch.Tensor,
                               block_tables: torch.Tensor,
                               seq_lens: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K5 (counterpart of the reference's
    ``ops._blocked_indexer``, with the kernel's per-row dead blocks): q_idx
    (B, Hi, Di); w_head (B, Hi) -> (B, mb*bs) fp32."""
    return indexer_fold_blocks(q_idx[:, None], w_head[:, None], k_pool,
                               block_tables, seq_lens)[:, 0]


def paged_indexer_scores_kernel(q_idx: torch.Tensor, w_head: torch.Tensor,
                                k_pool: torch.Tensor,
                                block_tables: torch.Tensor,
                                seq_lens: torch.Tensor) -> torch.Tensor:
    """K5: q_idx (B, Hi, Di) in the pool's dtype; w_head (B, Hi) fp32
    softmaxed head weights; k_pool (nb, bs, Di); tables (B, mb) int32;
    seq_lens (B,) int32 (the query's position) -> scores (B, mb*bs) fp32 in
    view coordinates (index == absolute position); blocks past
    ``seq_lens[b]``'s are NEG_INF.

    CPU and meta tensors run ``paged_indexer_scores_plain``; CUDA tensors launch the
    Hopper kernel on the current stream: bf16 at Hi 8, 16 or 32 the
    tensor-core decode body (a CTA per 128 view positions and row, a warp
    32 of them), fp32 and other head counts the SIMT tile (a CTA per 128
    view positions and row)."""
    refuse_dtensor("paged_indexer_scores_kernel", q_idx, w_head, k_pool,
                   block_tables, seq_lens)
    if q_idx.device.type in ("cpu", "meta"):
        return paged_indexer_scores_plain(q_idx, w_head, k_pool,
                                          block_tables, seq_lens)
    B, Hi, Di = q_idx.shape
    check_cuda_indexer_args(q_idx, w_head, k_pool, block_tables, seq_lens, Hi)
    bs, mb = k_pool.shape[1], block_tables.shape[1]
    out = w_head.new_empty((B, mb * bs))
    err = cuda_entry("paged_indexer_scores")(
        _DTYPE_CODE[q_idx.dtype], Di, bs, q_idx.data_ptr(), w_head.data_ptr(),
        k_pool.data_ptr(), block_tables.data_ptr(), seq_lens.data_ptr(),
        out.data_ptr(), B, Hi, mb, Di ** -0.5,
        torch._C._cuda_getCurrentRawStream(q_idx.get_device()))
    _check_launch("paged_indexer_scores", err)
    count_launch(paged_indexer_scores_kernel)
    return out


paged_indexer_scores_kernel.launches = 0
