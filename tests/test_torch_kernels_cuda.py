"""PyTorch port, the training path's CUDA kernels (K7, K9, K10), the
block selector's (K8), the GQA and MLA split-KV decodes (K1, K3), the GQA
and MLA span prefills (K2, K4), the DSA indexer decode and span (K5, K6)
and the selective scan (K11: Mamba-1's model and contract forms, Mamba-2's
head-shared form) against their plain versions on the card.

K2, K4, K8 and K9 run a bf16 body on the tensor cores
(``csrc/mma_tile.cuh``; K4's MLA form in ``csrc/paged_mla.cu``; K9's
forced here to every key-range split 1..4 through
``launch_flash_attention``); K2's and K4's fp32 bodies run on the CUDA
cores; K8, K9 and K10 run their fp32 routes on the tensor cores by 3xTF32
(``csrc/tf32_tile.cuh``, ``csrc/chunked_ce.cu``; K8's forced here to every
key-range split 1..4 through ``launch_block_sparse``), and K10's bf16
route on the CUDA cores; K6's bf16 route at Hi 8 / 16 / 32 and both of
K7's routes at Hi 8 / 16 / 32 run the indexer tensor-core body
(``csrc/indexer_mma.cuh``: bf16 mma.sync, fp32 by 3xTF32), K7 at other
head counts the SIMT tile; K1 cuts each row's live range into runs of
blocks, a CTA each, folded by a combine pass (forced here to every count
1..16 through its C entry point); K11 gives a thread each channel and cuts
time into chunks (forced here to every count the rule can pick through
``launch_scan_model``; S 1 runs its one-step kernel; its head-shared form
the same through ``launch_scan_heads`` at N 16 and 64, and at a head dim
of 64 its chunked route on the tensor cores through
``launch_scan_heads_chunked`` at N 16 / 32 / 64 with 1, 3 and 8 heads a
chunk CTA); K1 and K2 also at
zamba2's head dim 80 (MHA and GQA, both dtypes, every block size), beside
K9's bf16 tile, which shares K2's bf16 tensor-core tile, at d 64 / 128;
K9 at d 80 too (zamba2's shared block in training: both tiles, 32 / 32
heads and G 4, every option; K7 at its 8 x 64 indexer, both dtypes);
K3's bf16 route runs K4's tensor-core tile over a one-token span with
each row's key rounds split over parts (forced here to every count 1..16
through ``launch_decode_mla``), its fp32 route the SIMT body; K5's bf16
route at Hi 8 / 16 / 32 runs the decode form of the indexer tensor-core
body, fp32 and
other head counts the SIMT tile.  Each is
held over every case its dispatch takes (head dims, block sizes, groups,
window, softcap, q_offset, ragged rows, skipped ids, both empty-row rules,
and grids that the wrapper splits into 1, 2 or 4 key-range parts), at the
bf16 2e-2 and fp32 1e-4 bounds scaled by min(1, max|plain|), as
``chip_smoke.py`` holds them: an output row over ~1000 keys averages them,
so its magnitude is well under 1.

Every case is ``cuda``-marked and skips itself without a GPU.  This file
imports no JAX, so it runs on the machine with the card, where JAX is not
installed (``PYTHONPATH=src python -m pytest --noconftest -m cuda
tests/test_torch_kernels_cuda.py``).  Inputs are numpy-seeded; tolerances
are those of K1-K6 (fp32 1e-4, bf16 2e-2; both versions widen bf16 inputs
to fp32 and differ only in the order of their sums), and K10's loss sum is
held to 1e-5 relative (it adds 1000 token NLLs in another order).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.chunked_ce import kernel as K10
from repro_torch.kernels.flash_attention import kernel as K9
from repro_torch.kernels.lightning_indexer import kernel as K7
from repro_torch.kernels.mamba_scan import kernel as K11
from repro_torch.kernels.mamba_scan import ref as K11ref
from repro_torch.kernels.paged_attention import kernel as K1
from repro_torch.kernels.paged_attention import prefill as K2
from repro_torch.kernels.paged_attention import prefill as K6
from repro_torch.kernels.sparse_attention import kernel as K8

DTYPES = [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)]


def _cuda(rng, *shape, dtype=torch.float32):
    return torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).cuda().to(dtype)


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_flash_attention_matches_plain(dtype, tol):
    _need_gpu()
    rng = np.random.default_rng(0)
    for d, (Sq, Sk, kw) in zip((64, 128, 256), [
            (197, 197, dict()), (100, 333, dict(q_offset=233)),
            (131, 131, dict(window=40, softcap=30.0))]):
        q = _cuda(rng, 2, Sq, 8, d, dtype=dtype)
        k, v = (_cuda(rng, 2, Sk, 2, d, dtype=dtype) for _ in range(2))
        got = K9.flash_attention(q, k, v, **kw).float()
        want = K9.reference(q, k, v, **kw).float()
        torch.cuda.synchronize()
        assert (got - want).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_lightning_indexer_matches_plain(dtype, tol):
    _need_gpu()
    rng = np.random.default_rng(1)
    for Hi, Di in ((16, 64), (32, 128)):
        q, k = _cuda(rng, 2, 150, Hi * Di, dtype=dtype), \
            _cuda(rng, 2, 333, Di, dtype=dtype)
        w = torch.softmax(_cuda(rng, 2, 150, Hi), -1)
        got = K7.lightning_indexer(q, w, k, heads=Hi, head_dim=Di)
        want = K7.reference(q, w, k, heads=Hi, head_dim=Di)
        torch.cuda.synchronize()
        assert (got - want).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("Hi,Di", [(16, 64), (32, 128), (16, 16), (8, 64),
                                   (8, 128)])
@pytest.mark.parametrize("S,T", [(1, 65), (37, 333), (256, 4100)])
def test_lightning_indexer_tensor_cores_match_plain(dtype, tol, Hi, Di, S,
                                                    T):
    """K7 at Hi 8 / 16 / 32, both routes on the tensor cores (bf16
    mma.sync, fp32 by 3xTF32; at 8 heads one n-tile, zamba2 + DSA's 8 x
    64): S and T ragged against the tokens a CTA and the keys a chunk, one
    query, two batch rows; every (s, t) finite (K7 writes no NEG_INF) and
    within tol x min(1, max|plain|); the resource query answers for the
    shape."""
    _need_gpu()
    rng = np.random.default_rng(Hi + Di + S)
    q = _cuda(rng, 2, S, Hi * Di, dtype=dtype)
    k = _cuda(rng, 2, T, Di, dtype=dtype)
    w = torch.softmax(_cuda(rng, 2, S, Hi), -1)
    from repro_torch.kernels import build
    assert K7.body(Hi, Di) == "indexer_mma"
    assert build.resources("lightning_indexer_resources",
                           build.DTYPE_CODE[dtype], Hi, Di)[3] >= 1
    before = K7.lightning_indexer.launches
    got = K7.lightning_indexer(q, w, k, heads=Hi, head_dim=Di)
    want = K7.reference(q, w, k, heads=Hi, head_dim=Di)
    torch.cuda.synchronize()
    assert K7.lightning_indexer.launches == before + 1
    assert (got > -1e29).all()
    _hold(got, want, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("Hi,Di", [(2, 16), (4, 64), (4, 128)])
def test_lightning_indexer_simt_route_at_other_heads(dtype, tol, Hi, Di):
    """Head counts other than 8, 16 and 32 keep the SIMT tile: the
    tensor-core body's resource query refuses them, and the kernel matches
    plain."""
    _need_gpu()
    from repro_torch.kernels import build
    assert K7.body(Hi, Di) == "indexer_tile"
    with pytest.raises(RuntimeError):
        build.resources("lightning_indexer_resources",
                        build.DTYPE_CODE[dtype], Hi, Di)
    rng = np.random.default_rng(Hi * Di)
    q = _cuda(rng, 2, 150, Hi * Di, dtype=dtype)
    k = _cuda(rng, 2, 333, Di, dtype=dtype)
    w = torch.softmax(_cuda(rng, 2, 150, Hi), -1)
    got = K7.lightning_indexer(q, w, k, heads=Hi, head_dim=Di)
    want = K7.reference(q, w, k, heads=Hi, head_dim=Di)
    torch.cuda.synchronize()
    _hold(got, want, tol)


@pytest.mark.cuda
def test_lightning_indexer_refuses_what_it_cannot_take():
    _need_gpu()
    rng = np.random.default_rng(13)
    q, k = _cuda(rng, 1, 8, 16 * 64), _cuda(rng, 1, 40, 64)
    w = torch.softmax(_cuda(rng, 1, 8, 16), -1)
    with pytest.raises(ValueError):           # head dim not taken
        K7.lightning_indexer(_cuda(rng, 1, 8, 16 * 48), w,
                             _cuda(rng, 1, 40, 48), heads=16, head_dim=48)
    with pytest.raises(TypeError):            # q and k in two dtypes
        K7.lightning_indexer(q, w, k.bfloat16(), heads=16, head_dim=64)
    with pytest.raises(TypeError):            # bf16 head weights
        K7.lightning_indexer(q, w.bfloat16(), k, heads=16, head_dim=64)
    with pytest.raises(ValueError):           # not contiguous
        K7.lightning_indexer(q.transpose(0, 1), w, k, heads=16, head_dim=64)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_ce_matches_plain(dtype):
    _need_gpu()
    rng = np.random.default_rng(2)
    for softcap in (0.0, 30.0):
        h = _cuda(rng, 1000, 256, dtype=dtype)
        w = (_cuda(rng, 256, 1000) / 16).to(dtype)
        t = torch.from_numpy(rng.integers(0, 1000, 1000).astype(np.int32))
        m = torch.from_numpy((rng.random(1000) > 0.3).astype(np.float32))
        t, m = t.cuda(), m.cuda()
        got = K10.chunked_ce(h, w, t, m, softcap=softcap)
        want = K10.reference(h, w, t, m, softcap=softcap)
        torch.cuda.synchronize()
        np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-5)
        assert float(got[1]) == float(want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("Tk,D,V,softcap", [
    (1000, 256, 1000, 0.0),        # ragged token and vocab tiles
    (1000, 256, 1000, 30.0),
    (333, 100, 1001, 0.0),         # V not a multiple of 4: 4-byte copies
    (130, 97, 129, 30.0),          # D not a multiple of 4 or 32
    (4096, 4096, 1000, 0.0),       # the training width, a short vocab
])
def test_chunked_ce_tf32_tile_matches_plain(Tk, D, V, softcap):
    """K10's fp32 route (3xTF32) against ``ref.reference`` at 1e-5
    relative, a partial mask."""
    _need_gpu()
    rng = np.random.default_rng(Tk + D + V)
    h = _cuda(rng, Tk, D)
    w = _cuda(rng, D, V) / D ** 0.5
    t = torch.from_numpy(rng.integers(0, V, Tk).astype(np.int32)).cuda()
    m = torch.from_numpy((rng.random(Tk) > 0.3).astype(np.float32)).cuda()
    got = K10.chunked_ce(h, w, t, m, softcap=softcap)
    want = K10.reference(h, w, t, m, softcap=softcap)
    torch.cuda.synchronize()
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-5)
    assert float(got[1]) == float(want[1])


def _decode_tables(rng, lens, bs, mb):
    """Disjoint shuffled tables, the trash block last (nb - 1), row b's
    live blocks those of lens[b] (an idle slot, length 0, owns none)."""
    live = [0 if n == 0 else n // bs + 1 for n in lens]
    nb = sum(live) + 1
    t = np.full((len(lens), mb), nb - 1, np.int32)
    ids, at = rng.permutation(nb - 1), 0
    for b, n in enumerate(live):
        t[b, :n] = ids[at:at + n]
        at += n
    return torch.from_numpy(t).cuda(), \
        torch.tensor(lens, dtype=torch.int32).cuda(), nb


def _k1_inputs(rng, dtype, KVH, G, d, bs, mb, lens):
    """Pools with the trash block last, row 0 an idle slot (length 0, all
    trash), the other rows' blocks disjoint and shuffled."""
    tables, sl, nb = _decode_tables(rng, lens, bs, mb)
    kp = _cuda(rng, nb, bs, KVH, d, dtype=dtype)
    vp = _cuda(rng, nb, bs, KVH, d, dtype=dtype)
    q = _cuda(rng, len(lens), KVH, G, d, dtype=dtype)
    return q, kp, vp, tables, sl


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("case", [
    # (KVH, G, d, bs, mb, lens, window, softcap)
    (4, 8, 128, 16, 82, [0, 1, 15, 16, 531, 1039, 300, 777], 0, 0.0),
    (2, 3, 64, 8, 12, [0, 2, 7, 8, 40, 95], 0, 0.0),
    (4, 2, 256, 16, 12, [0, 5, 64, 100, 191], 64, 50.0),
    (2, 12, 128, 32, 6, [0, 31, 32, 150, 191], 40, 30.0),
    (2, 6, 128, 8, 40, [0, 1, 7, 8, 200, 311], 0, 0.0),
    (1, 16, 128, 16, 20, [0, 15, 16, 300, 319], 0, 0.0),
])
def test_paged_decode_gqa_split_matches_plain(dtype, tol, case):
    """K1 through its C entry point with the live range cut into every
    count of runs 1..16 (more runs than a row's blocks leaves some empty),
    and through the wrapper (its own count): an idle slot, ragged lengths,
    G 2 / 3 / 6 / 8 / 12 / 16 (two row tiles at 12 and 16), window and
    softcap."""
    _need_gpu()
    KVH, G, d, bs, mb, lens, window, softcap = case
    rng = np.random.default_rng(len(lens) + d)
    q, kp, vp, tables, sl = _k1_inputs(rng, dtype, KVH, G, d, bs, mb, lens)
    want = K1.paged_decode_gqa_plain(q, kp, vp, tables, sl, window=window,
                                     softcap=softcap)
    for parts in range(1, K1.MAX_DECODE_PARTS + 1):
        got = K1.launch_decode_gqa(q, kp, vp, tables, sl, window, softcap,
                                   parts)
        torch.cuda.synchronize()
        _hold(got, want, tol)
    before = K1.paged_decode_gqa.launches
    _hold(K1.paged_decode_gqa(q, kp, vp, tables, sl, window=window,
                              softcap=softcap), want, tol)
    assert K1.paged_decode_gqa.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("bs", [8, 16, 32])
@pytest.mark.parametrize("KVH,G", [(32, 1), (4, 4)])
def test_paged_decode_gqa_head_dim_80(dtype, tol, bs, KVH, G):
    """K1 at zamba2's head dim 80 (the bf16 body's half chunk, the fp32
    body's 20 live lanes a key): MHA with 32 heads (G 1: one live row of
    the CTA's 8) and GQA G 4, an idle slot and ragged lengths, every count
    of runs 1..16 and the wrapper's."""
    _need_gpu()
    lens = [0, 1, bs - 1, bs, 300, 777, 1039, 2 * bs + 3]
    rng = np.random.default_rng(80 + bs + G)
    q, kp, vp, tables, sl = _k1_inputs(rng, dtype, KVH, G, 80, bs,
                                       max(lens) // bs + 2, lens)
    want = K1.paged_decode_gqa_plain(q, kp, vp, tables, sl)
    for parts in range(1, K1.MAX_DECODE_PARTS + 1):
        got = K1.launch_decode_gqa(q, kp, vp, tables, sl, 0, 0.0, parts)
        torch.cuda.synchronize()
        _hold(got, want, tol)
    _hold(K1.paged_decode_gqa(q, kp, vp, tables, sl), want, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("KVH,G", [(32, 1), (4, 3)])
def test_paged_decode_gqa_head_dim_96(dtype, tol, bs, KVH, G):
    """K1 at phi-3-vision's head dim 96 (the bf16 body's three whole
    32-dim chunks, the fp32 body's 24 live lanes a key): MHA with 32 heads
    and GQA G 3, an idle slot and ragged lengths, every count of runs
    1..16 and the wrapper's."""
    _need_gpu()
    lens = [0, 1, bs - 1, bs, 300, 777, 1039, 2 * bs + 3]
    rng = np.random.default_rng(96 + bs + G)
    q, kp, vp, tables, sl = _k1_inputs(rng, dtype, KVH, G, 96, bs,
                                       max(lens) // bs + 2, lens)
    want = K1.paged_decode_gqa_plain(q, kp, vp, tables, sl)
    for parts in range(1, K1.MAX_DECODE_PARTS + 1):
        got = K1.launch_decode_gqa(q, kp, vp, tables, sl, 0, 0.0, parts)
        torch.cuda.synchronize()
        _hold(got, want, tol)
    _hold(K1.paged_decode_gqa(q, kp, vp, tables, sl), want, tol)


@pytest.mark.cuda
def test_paged_decode_gqa_refuses_what_it_cannot_take():
    _need_gpu()
    rng = np.random.default_rng(9)
    q, kp, vp, tables, sl = _k1_inputs(rng, torch.float32, 2, 4, 64, 8, 4,
                                       [0, 9])
    for parts in (0, K1.MAX_DECODE_PARTS + 1):
        with pytest.raises(RuntimeError):
            K1.launch_decode_gqa(q, kp, vp, tables, sl, 0, 0.0, parts)
    for d in (96, 48):                       # no such instantiation
        q, kp, vp, tables, sl = _k1_inputs(rng, torch.float32, 2, 4, d, 8, 4,
                                           [0, 9])
        with pytest.raises(ValueError):
            K1.paged_decode_gqa(q, kp, vp, tables, sl)


def _hold(got, want, tol):
    """Finite, and max abs error <= tol * min(1, max|plain|)."""
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    scale = min(1.0, want.abs().max().item())
    err = (got - want).abs().max().item()
    assert err <= tol * scale, f"max abs err {err} > {tol * scale}"


def _k2_case(rng, dtype, tol, B, KVH, G, d, bs, S, starts, mb, window=0,
             softcap=0.0, trash_row=False):
    """K2 over shuffled disjoint tables (row 0 all trash with
    ``trash_row``; unused entries point at the trash block)."""
    live = [(s + S - 1) // bs + 1 for s in starts]
    nb = sum(live) + 1
    kp = _cuda(rng, nb, bs, KVH, d, dtype=dtype)
    vp = _cuda(rng, nb, bs, KVH, d, dtype=dtype)
    ids = rng.permutation(nb - 1)
    t = np.full((B, mb), nb - 1, np.int32)
    at = 0
    for b, n in enumerate(live):
        if not (trash_row and b == 0):
            t[b, :n] = ids[at:at + n]
            at += n
    tables = torch.from_numpy(t).cuda()
    st = torch.tensor(starts, dtype=torch.int32).cuda()
    q = _cuda(rng, B, KVH, S * G, d, dtype=dtype)
    kw = dict(groups=G, window=window, softcap=softcap)
    got = K2.paged_prefill_gqa(q, kp, vp, tables, st, **kw)
    want = K2.paged_prefill_gqa_plain(q, kp, vp, tables, st, **kw)
    torch.cuda.synchronize()
    _hold(got, want, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("d", [64, 80, 96, 128, 256])
@pytest.mark.parametrize("bs", [8, 16, 32])
def test_paged_prefill_gqa_matches_plain(dtype, tol, d, bs):
    """K2 at every (head dim, block size) it instantiates, G 1 / 3 / 8 with
    S*G of 5, 63 and 296 (not a multiple of 16 or 64): a trash row, a span
    starting mid-block, one at a block edge, one ending at the table's last
    position."""
    _need_gpu()
    rng = np.random.default_rng(6)
    mb = 16
    for G, S in ((1, 5), (3, 21), (8, 37)):
        _k2_case(rng, dtype, tol, 4, 2, G, d, bs, S,
                 [0, bs + bs // 2, 2 * bs, mb * bs - S], mb, trash_row=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("bs", [8, 16])
def test_paged_prefill_gqa_group_sizes_6_and_16(dtype, tol, bs):
    """K2 at nemotron-4's G 6 and qwen3-moe's G 16 (d 128): packed rows
    i*G + g cut into 64-row tiles at no token edge (S*G 6 * 21 = 126 and
    16 * 9 = 144), a trash row, spans mid-block and at the table's end."""
    _need_gpu()
    rng = np.random.default_rng(616)
    mb = 16
    for KVH, G, S in ((2, 6, 21), (1, 16, 9)):
        _k2_case(rng, dtype, tol, 4, KVH, G, 128, bs, S,
                 [0, bs + bs // 2, 2 * bs, mb * bs - S], mb, trash_row=True)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_flash_attention_bf16_tile_beside_d80(d):
    """K9's bf16 route runs the tensor-core tile K2's bf16 route shares
    (``csrc/mma_tile.cuh``; K2 beside it at d 80): at d 64 / 128 it is
    held on rows that are not a multiple of the tile's 64, G 1 and 4, with
    and without q_offset."""
    _need_gpu()
    rng = np.random.default_rng(d)
    for Sq, H, KVH, kw in ((77, 4, 4, dict()), (45, 8, 2,
                                                dict(q_offset=30))):
        Sk = Sq + kw.get("q_offset", 0)
        q = _cuda(rng, 2, Sq, H, d, dtype=torch.bfloat16)
        k, v = (_cuda(rng, 2, Sk, KVH, d, dtype=torch.bfloat16)
                for _ in range(2))
        got = K9.flash_attention(q, k, v, **kw)
        want = K9.reference(q, k, v, **kw)
        torch.cuda.synchronize()
        _hold(got, want, 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 80, 96, 128, 256])
@pytest.mark.parametrize("kw", [
    dict(), dict(window=40, softcap=30.0), dict(q_offset=211),
    dict(q_offset=211, window=48, softcap=20.0), dict(causal=False),
    dict(causal=False, window=50)])
def test_flash_attention_bf16_tile_every_split(d, kw):
    """K9's bf16 route, the tensor-core tile, through
    ``launch_flash_attention`` at every key-range split 1..4 and through
    the wrapper (its own parts): every head dim with each option, S*G 360
    and 90 (not multiples of the 64-row tile), G 4 and 1, Sk ragged (301
    with q_offset and non-causal, so the last round is part zero-filled),
    the loop backend's shape (B 1, S 240, 32 / 4 heads); rows that see no
    key (a window behind q_offset) give 0; bf16 2e-2 scaled by
    min(1, max|plain|)."""
    _need_gpu()
    rng = np.random.default_rng(9)
    Sk = 301 if "q_offset" in kw or not kw.get("causal", True) else 90
    for B, Sq, H, KVH in ((2, 90, 8, 2), (2, 90, 4, 4), (1, 240, 32, 4)):
        Sk_ = 240 if Sq == 240 and Sk == 90 else Sk
        q = _cuda(rng, B, Sq, H, d, dtype=torch.bfloat16)
        k, v = (_cuda(rng, B, Sk_, KVH, d, dtype=torch.bfloat16)
                for _ in range(2))
        want = K9.reference(q, k, v, **kw)
        for parts in (1, 2, 3, 4):
            got = K9.launch_flash_attention(q, k, v, parts=parts, **kw)
            torch.cuda.synchronize()
            _hold(got, want, 2e-2)
        before = K9.flash_attention.launches
        _hold(K9.flash_attention(q, k, v, **kw), want, 2e-2)
        assert K9.flash_attention.launches == before + 1
    # a window that ends before Sk: queries past Sk + window see no key
    q = _cuda(rng, 1, 70, 8, d, dtype=torch.bfloat16)
    k, v = (_cuda(rng, 1, 100, 2, d, dtype=torch.bfloat16) for _ in range(2))
    kw = dict(q_offset=120, window=30)
    want = K9.reference(q, k, v, **kw)
    assert (want[:, -40:] == 0).all()
    for parts in (1, 4):
        got = K9.launch_flash_attention(q, k, v, parts=parts, **kw)
        torch.cuda.synchronize()
        assert (got[:, -40:] == 0).all()
        _hold(got, want, 2e-2)


@pytest.mark.cuda
def test_flash_attention_bf16_parts_rule():
    """K9's bf16 split leaves one CTA an SM: parts 1 at the RL loop shape
    (120 tiles of 64 rows), 4 at 32 tiles (d 256, G 2), with a workspace
    of tiles x parts x 64 x (d + 2) floats."""
    _need_gpu()
    dev = torch.device("cuda", torch.cuda.current_device())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    parts = K9.bf16_parts(128, 240 * 8, 4, dev)
    assert parts == max(1, min(4, sms // 120))
    q = torch.empty((1, 240, 32, 128), dtype=torch.bfloat16, device=dev)
    k = torch.empty((1, 240, 4, 128), dtype=torch.bfloat16, device=dev)
    assert (K9.split_workspace(q, k, parts) is None) == (parts == 1)
    parts = K9.bf16_parts(256, 240 * 2, 4, dev)
    assert parts == max(1, min(4, sms // 32))
    q = torch.empty((1, 240, 8, 256), dtype=torch.bfloat16, device=dev)
    k = torch.empty((1, 240, 4, 256), dtype=torch.bfloat16, device=dev)
    ws = K9.split_workspace(q, k, parts)
    assert ws.numel() == 32 * parts * 64 * (256 + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("case", [
    # window and softcap (gemma2-like and narrower)
    dict(B=2, KVH=4, G=2, d=256, bs=16, S=37, starts=[3, 100], mb=12,
         window=64, softcap=50.0),
    dict(B=2, KVH=4, G=8, d=128, bs=8, S=50, starts=[0, 60], mb=16,
         window=40, softcap=30.0),
    # Yi-6B's serve span (128 tiles: 2 parts), a grid of 512 tiles (no
    # split) and one of 8 tiles over a long prefix (4 parts)
    dict(B=1, KVH=4, G=8, d=128, bs=16, S=256, starts=[768], mb=64),
    dict(B=2, KVH=8, G=8, d=128, bs=16, S=256, starts=[0, 500], mb=64),
    dict(B=1, KVH=4, G=8, d=128, bs=16, S=16, starts=[4000], mb=252),
])
def test_paged_prefill_gqa_windows_and_splits(dtype, tol, case):
    _need_gpu()
    _k2_case(np.random.default_rng(7), dtype, tol, **case)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("dqk,dv", [(64, 64), (128, 128), (192, 256)])
@pytest.mark.parametrize("B,S,H,KVH,bs,nb,T", [
    (2, 64, 4, 2, 16, 4, 256),         # the smoke shape
    (1, 256, 64, 64, 128, 8, 2048),    # GLM-5's MLA heads: G 1
    (2, 64, 8, 2, 16, 64, 1030),       # nb 64, T not a multiple of bs
    (1, 256, 32, 4, 128, 16, 2125),    # Yi-6B's serve blocks, ragged T
    (2, 256, 32, 8, 128, 16, 4096),    # 256 tiles: no key-range split
])
def test_block_sparse_attention_matches_plain(dtype, tol, dqk, dv, B, S, H,
                                              KVH, bs, nb, T):
    """K8 at every (dqk, dv) it instantiates, block sizes 16 and 128 and
    grids its bf16 wrapper splits into 1, 2 or 4 parts: a third of the ids
    skipped, one query block with none attended, queries from per-row
    starts, softcap 0 and 50, both rules for a query that sees no key."""
    _need_gpu()
    rng = np.random.default_rng(3)
    q = _cuda(rng, B, S, H, dqk, dtype=dtype)
    k = _cuda(rng, B, T, KVH, dqk, dtype=dtype)
    v = _cuda(rng, B, T, KVH, dv, dtype=dtype)
    blocks = -(-T // bs)
    ids = np.stack([[rng.permutation(blocks)[:nb] for _ in range(S // bs)]
                    for _ in range(B)])
    ids = np.where(rng.random(ids.shape) < 0.3, -ids - 1, ids)
    ids[0, 0] = -np.abs(ids[0, 0]) - 1
    ids = torch.from_numpy(ids.astype(np.int32)).cuda()
    start = torch.tensor([T - S - 3 * b for b in range(B)],
                         dtype=torch.int32).cuda()
    for softcap in (0.0, 50.0):
        for empty_mean in (True, False):
            kw = dict(block_size=bs, softcap=softcap, empty_mean=empty_mean)
            got = K8.block_sparse_attention(q, k, v, ids, start, **kw)
            want = K8.block_sparse_attention_plain(q, k, v, ids, start, **kw)
            torch.cuda.synchronize()
            _hold(got, want, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dqk,dv", [(64, 64), (128, 128), (192, 256)])
@pytest.mark.parametrize("B,S,H,KVH,bs,nb,T", [
    (2, 64, 8, 2, 16, 6, 300),          # blocks of 16, T not a multiple
    (1, 256, 32, 4, 128, 16, 4096),     # Yi-6B's training chunk
])
def test_block_sparse_tf32_tile_every_split(dqk, dv, B, S, H, KVH, bs, nb,
                                            T):
    """K8's fp32 route, the 3xTF32 tile, through its C entry point with the
    keys of every tile split over 1, 2, 3 and 4 CTAs: a third of the ids
    skipped, the last query block of row 0 with none attended, queries
    from per-row starts (ids past a tile's last query are not listed),
    softcap 0 and 30, both rules for a query that sees no key; fp32 1e-4
    scaled by min(1, max|plain|)."""
    _need_gpu()
    rng = np.random.default_rng(11)
    q = _cuda(rng, B, S, H, dqk)
    k = _cuda(rng, B, T, KVH, dqk)
    v = _cuda(rng, B, T, KVH, dv)
    blocks = -(-T // bs)
    ids = np.stack([[rng.permutation(blocks)[:nb] for _ in range(S // bs)]
                    for _ in range(B)])
    ids = np.where(rng.random(ids.shape) < 0.3, -ids - 1, ids)
    ids[0, -1] = -np.abs(ids[0, -1]) - 1
    ids = torch.from_numpy(ids.astype(np.int32)).cuda()
    start = torch.tensor([T - S - 5 * b for b in range(B)],
                         dtype=torch.int32).cuda()
    for softcap in (0.0, 30.0):
        for empty_mean in (True, False):
            kw = dict(block_size=bs, softcap=softcap, empty_mean=empty_mean)
            want = K8.block_sparse_attention_plain(q, k, v, ids, start, **kw)
            for parts in (1, 2, 3, 4):
                got = K8.launch_block_sparse(q, k, v, ids, start,
                                             parts=parts, **kw)
                torch.cuda.synchronize()
                _hold(got, want, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("Hi,Di", [(16, 64), (32, 128), (8, 64), (8, 128),
                                   (8, 16)])
@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("S", [37, 256])
def test_paged_prefill_indexer_tensor_cores_match_plain(Hi, Di, bs, S):
    """K6's bf16 route, the tensor-core body, at Yi-6B's, GLM-5's and
    zamba2's (8 x 64: one n-tile of heads) indexer shapes and 8 heads at
    the widest and narrowest index dims: an idle slot (length 0, every
    table entry the trash block), spans from 0, mid-block, at a block edge
    and ending at the table's last position, a view past 4 chunks of keys;
    dead blocks NEG_INF in both,
    the live scores within the bf16 2e-2 scaled by min(1, max|plain|)."""
    _need_gpu()
    rng = np.random.default_rng(Hi + bs + S)
    mb = (1100 + S) // bs + 1
    starts = [0, 0, bs + bs // 2, 2 * bs, 1100, mb * bs - S]
    B = len(starts)
    live = [0] + [(st + S - 1) // bs + 1 for st in starts[1:]]
    nb = sum(live) + 1
    tables = np.full((B, mb), nb - 1, np.int32)          # row 0: idle slot
    perm, at = rng.permutation(nb - 1), 0
    for b, n in enumerate(live):
        tables[b, :n] = perm[at:at + n]
        at += n
    kp = _cuda(rng, nb, bs, Di, dtype=torch.bfloat16)
    q = _cuda(rng, B, S * Hi, Di, dtype=torch.bfloat16)
    w = torch.softmax(_cuda(rng, B, S, Hi), -1).reshape(B, S * Hi)
    tables = torch.from_numpy(tables).cuda()
    st = torch.tensor(starts, dtype=torch.int32).cuda()
    got = K6.paged_prefill_indexer(q, w, kp, tables, st, heads=Hi)
    want = K6.paged_prefill_indexer_plain(q, w, kp, tables, st, heads=Hi)
    torch.cuda.synchronize()
    dead = want <= -1e29
    assert torch.equal(got <= -1e29, dead)
    _hold(got.masked_fill(dead, 0.0), want.masked_fill(dead, 0.0), 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 80, 96, 128, 256])
@pytest.mark.parametrize("kw", [
    dict(), dict(window=40, softcap=30.0), dict(q_offset=211),
    dict(q_offset=211, window=48, softcap=20.0), dict(causal=False),
    dict(causal=False, window=50)])
def test_flash_attention_tf32_tile_matches_plain(d, kw):
    """K9's fp32 route, the 3xTF32 tensor-core tile, at every head dim it
    instantiates with each option: S*G 360 and 90 (not multiples of the
    64-row tile), G 4 and 1, Sk ragged (301 with q_offset, Sq < Sk, and
    non-causal); fp32 1e-4 scaled by min(1, max|plain|)."""
    _need_gpu()
    rng = np.random.default_rng(8)
    Sk = 301 if "q_offset" in kw or not kw.get("causal", True) else 90
    for Sq, H, KVH in ((90, 8, 2), (90, 4, 4)) + (((70, 32, 32),)
                                                  if d == 80 else ()):
        q = _cuda(rng, 2, Sq, H, d)
        k, v = (_cuda(rng, 2, Sk, KVH, d) for _ in range(2))
        got = K9.flash_attention(q, k, v, **kw)
        want = K9.reference(q, k, v, **kw)
        torch.cuda.synchronize()
        _hold(got, want, 1e-4)


def _k4_case(rng, dtype, tol, H, bs, S, starts):
    """K4 over shuffled disjoint tables, row 0 a trash row (no block of its
    own); q_lat fp32, q_rope and the pools in ``dtype``."""
    L, R = 512, 64
    B = len(starts)
    mb = (max(starts) + S - 1) // bs + 1
    live = [0] + [(s + S - 1) // bs + 1 for s in starts[1:]]
    nb = sum(live) + 1
    c, kr = _cuda(rng, nb, bs, L, dtype=dtype), _cuda(rng, nb, bs, R,
                                                       dtype=dtype)
    ids = rng.permutation(nb - 1)
    t = np.full((B, mb), nb - 1, np.int32)
    at = 0
    for b, n in enumerate(live):
        t[b, :n] = ids[at:at + n]
        at += n
    tables = torch.from_numpy(t).cuda()
    st = torch.tensor(starts, dtype=torch.int32).cuda()
    q_lat = _cuda(rng, B, S * H, L)
    q_rope = _cuda(rng, B, S * H, R, dtype=dtype)
    kw = dict(heads=H, scale=192 ** -0.5)
    got = K2.paged_prefill_mla(q_lat, q_rope, c, kr, tables, st, **kw)
    want = K2.paged_prefill_mla_plain(q_lat, q_rope, c, kr, tables, st, **kw)
    torch.cuda.synchronize()
    _hold(got, want, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("H", [16, 64])
@pytest.mark.parametrize("bs", [8, 16, 32])
@pytest.mark.parametrize("S", [37, 4])
def test_paged_prefill_mla_matches_plain(dtype, tol, H, bs, S):
    """K4: bf16 the tensor-core tile, fp32 the SIMT body.  A trash row,
    spans from position 1, across a block edge, at one, mid-block and
    ending at the table's last position; S 37 (ragged tiles) and the
    verify span S 4, whose 8 or 32 tiles the bf16 wrapper splits into 4
    key-range parts."""
    _need_gpu()
    _k4_case(np.random.default_rng(9), dtype, tol, H, bs, S,
             [0, 1, bs - 2, bs, bs + bs // 2, 300, 48 * bs - S])


def _scan_inputs(rng, B, S, E, N, dtype, h0_dtype):
    dt = torch.nn.functional.softplus(_cuda(rng, B, S, E) - 1.0).to(dtype)
    A = -torch.arange(1, N + 1, dtype=torch.float32, device="cuda") \
        .expand(E, N).contiguous()
    x, Bc, Cc = (_cuda(rng, *s, dtype=dtype)
                 for s in ((B, S, E), (B, S, N), (B, S, N)))
    h0 = (0.5 * _cuda(rng, B, E, N)).to(h0_dtype)
    return dt, A, x, Bc, Cc, h0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_mamba_scan_matches_plain(dtype, tol):
    """Both entry points of K11 at ragged E, S 1 and S past a tile, N 4, 8
    and 16, fp32 and bf16 states; y and hT within tol x min(1, max|plain|),
    the contract form's (stored in dtype) plus one unit in the last place
    of each element's magnitude, where the two versions round to
    neighbouring stored values."""
    _need_gpu()
    rng = np.random.default_rng(4)
    for B, S, E, N in ((2, 7, 96, 16), (1, 1, 512, 8), (2, 70, 64, 4),
                       (1, 300, 8192, 16)):
        for h0_dtype in (torch.float32, torch.bfloat16):
            ins = _scan_inputs(rng, B, S, E, N, dtype, h0_dtype)
            got = K11.mamba_scan_model(*ins)
            want = K11ref.scan_model(*ins)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                scale = min(1.0, b.abs().max().item())
                assert (a - b).abs().max().item() <= tol * scale
        dt, A, x, Bc, Cc, h0 = ins
        dA, dBx = (t.to(dtype) for t in K11ref.discretize(dt, A, x, Bc))
        h0 = h0.to(dtype)
        got = K11.mamba_scan(dA, dBx, Cc, h0)
        want = K11ref.reference(dA, dBx, Cc, h0)
        torch.cuda.synchronize()
        ulp = torch.finfo(dtype).eps          # one ulp, at most
        for a, b in zip(got, want):
            a, b = a.float(), b.float()
            scale = min(1.0, b.abs().max().item())
            assert ((a - b).abs() <= tol * scale + ulp * b.abs()).all()


@pytest.mark.cuda
def test_mamba_scan_refuses_what_it_cannot_take():
    _need_gpu()
    rng = np.random.default_rng(5)
    dt, A, x, Bc, Cc, h0 = _scan_inputs(rng, 1, 5, 24, 8, torch.float32,
                                        torch.float32)
    with pytest.raises(ValueError):           # N does not divide 32
        K11.mamba_scan_model(dt, A[:, :6].contiguous(), x, Bc[..., :6]
                             .contiguous(), Cc[..., :6].contiguous(),
                             h0[..., :6].contiguous())
    with pytest.raises(ValueError):           # not contiguous
        K11.mamba_scan_model(dt.transpose(0, 1), A, x, Bc, Cc, h0)
    with pytest.raises(TypeError):            # A must be fp32
        K11.mamba_scan_model(dt, A.bfloat16(), x, Bc, Cc, h0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h0_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,E,N", [(2, 1, 96, 16), (1, 1, 8192, 16),
                                     (2, 1, 100, 1), (3, 301, 96, 16),
                                     (2, 1000, 200, 8), (1, 130, 40, 32),
                                     (2, 77, 64, 2)])
def test_mamba_scan_model_every_parts(dtype, h0_dtype, B, S, E, N):
    """K11's model form through its C entry point at every count of time
    chunks the rule can pick (1..16, at most S; S 1 is the one-step decode
    kernel), and through the wrapper (its own count, one launch on the
    count): ragged E and S, N 1 to 32, both h0 dtypes; y and hT in fp32 on
    both sides, so each within the fp32 1e-4 x min(1, max|plain|)."""
    _need_gpu()
    rng = np.random.default_rng(B * S + E + N)
    ins = _scan_inputs(rng, B, S, E, N, dtype, h0_dtype)
    want = K11ref.scan_model(*ins)
    for parts in sorted({1, 2, 3, 4, 7, 16} & set(range(1, S + 1))):
        got = K11.launch_scan_model(*ins, parts)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            _hold(a, b, 1e-4)
    before = K11.mamba_scan_model.launches
    got = K11.mamba_scan_model(*ins)
    torch.cuda.synchronize()
    assert K11.mamba_scan_model.launches == before + 1
    for a, b in zip(got, want):
        _hold(a, b, 1e-4)


@pytest.mark.cuda
def test_mamba_scan_parts_rule_at_the_main_shapes():
    """The wrapper's time chunks at falcon-mamba's shapes (E 8192, N 16):
    one at the serve prefill (B 8 fills the card), more at the training
    shape (B 2), one at a decode step."""
    _need_gpu()
    code, index = 1, torch.cuda.current_device()
    assert K11.scan_parts(code, code, 16, 8, 1, 8192, index) == 1
    train = K11.scan_parts(0, 0, 16, 2, 2048, 8192, index)
    assert 1 < train <= K11.MAX_PARTS
    assert K11.scan_parts(code, code, 16, 8, 1024, 8192, index) <= train


@pytest.mark.cuda
def test_mamba_scan_model_refuses_parts_it_cannot_take():
    _need_gpu()
    rng = np.random.default_rng(6)
    ins = _scan_inputs(rng, 1, 5, 24, 8, torch.float32, torch.float32)
    for parts in (0, 6, K11.MAX_PARTS + 1):   # past S = 5, past the limit
        with pytest.raises(RuntimeError):
            K11.launch_scan_model(*ins, parts)


# ---------------------------------------------------------------------------
# K3 (absorbed-MLA decode) and K5 (indexer decode scores)
# ---------------------------------------------------------------------------

def _k3_inputs(rng, dtype, H, bs, lens, mb):
    tables, sl, nb = _decode_tables(rng, lens, bs, mb)
    c = _cuda(rng, nb, bs, 512, dtype=dtype)
    kr = _cuda(rng, nb, bs, 64, dtype=dtype)
    q_lat = _cuda(rng, len(lens), H, 512)
    q_rope = _cuda(rng, len(lens), H, 64, dtype=dtype)
    return q_lat, q_rope, c, kr, tables, sl


def _k3_lens(bs, B):
    """An idle slot, 1, 15, 16, 17 tokens (one round of 32 keys: the other
    parts hold none), then long rows up to the table's last position."""
    mb = 1100 // bs + 1
    lens = [0, 1, 15, 16, 17, 333, 1000, mb * bs - 1]
    return (lens * (B // len(lens) + 1))[:B], mb


@pytest.mark.cuda
@pytest.mark.parametrize("H", [16, 64])
@pytest.mark.parametrize("bs", [8, 16, 32])
@pytest.mark.parametrize("B", [8, 16, 32])
def test_paged_decode_mla_tile_every_parts(H, bs, B):
    """K3's bf16 route, the tensor-core tile, through its C entry point
    with each row's key rounds in every count of parts 1..16 (a short row
    leaves parts without a key), and through the wrapper (its own count,
    one launch counted); the bf16 2e-2 scaled by min(1, max|plain|)."""
    _need_gpu()
    rng = np.random.default_rng(H + bs + B)
    lens, mb = _k3_lens(bs, B)
    ins = _k3_inputs(rng, torch.bfloat16, H, bs, lens, mb)
    scale = 192 ** -0.5
    want = K1.paged_decode_mla_plain(*ins, scale=scale)
    for parts in range(1, K1.MAX_MLA_DECODE_PARTS + 1):
        got = K1.launch_decode_mla(*ins, scale, parts)
        torch.cuda.synchronize()
        _hold(got, want, 2e-2)
    before = K1.paged_decode_mla.launches
    _hold(K1.paged_decode_mla(*ins, scale=scale), want, 2e-2)
    assert K1.paged_decode_mla.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("H", [16, 64])
@pytest.mark.parametrize("bs", [8, 16, 32])
def test_paged_decode_mla_simt_route(H, bs):
    """K3's fp32 route, the SIMT body (parts 1), at fp32 1e-4."""
    _need_gpu()
    rng = np.random.default_rng(H * bs)
    lens, mb = _k3_lens(bs, 8)
    ins = _k3_inputs(rng, torch.float32, H, bs, lens, mb)
    scale = 192 ** -0.5
    _hold(K1.paged_decode_mla(*ins, scale=scale),
          K1.paged_decode_mla_plain(*ins, scale=scale), 1e-4)


@pytest.mark.cuda
def test_paged_decode_mla_parts_rule_at_the_serve_shape():
    """GLM-5's decode step (B 8, H 64, 82 blocks of 16): one 64-head tile a
    row, so the wrapper fills the card's CTA slots with up to 16 parts a
    row, K3's own cap; K2's, K4's and K8's key split keeps its cap of 4."""
    _need_gpu()
    from repro_torch.kernels import build
    index = torch.cuda.current_device()
    *_, per_sm, rows = build.resources("paged_mla_resources", 1, 512, 64)
    assert rows == K1.MLA_ROWS
    slots = per_sm * torch.cuda.get_device_properties(index) \
        .multi_processor_count
    parts, ws = K1.mla_decode_parts(8, 64, 512, 64, 82, index)
    assert parts == min(K1.MAX_MLA_DECODE_PARTS, slots // 8)
    assert ws == 8 * parts * 64 * 514
    assert build.MAX_PARTS == 4
    # a single row: the cap; a table of 2 blocks: at most 2 parts
    assert K1.mla_decode_parts(1, 64, 512, 64, 82, index)[0] \
        == K1.MAX_MLA_DECODE_PARTS
    assert K1.mla_decode_parts(1, 64, 512, 64, 2, index)[0] == 2


@pytest.mark.cuda
def test_paged_decode_mla_refuses_what_it_cannot_take():
    """Wrong dtypes raise TypeError, a misaligned tensor ValueError, parts
    out of range (bf16: 0 and 17; fp32: 2) RuntimeError from the C entry."""
    _need_gpu()
    rng = np.random.default_rng(11)
    lens, mb = _k3_lens(16, 8)
    ins = _k3_inputs(rng, torch.bfloat16, 64, 16, lens, mb)
    q_lat, q_rope, c, kr, tables, sl = ins
    scale = 192 ** -0.5
    with pytest.raises(TypeError):               # q_lat must be fp32
        K1.paged_decode_mla(q_lat.bfloat16(), q_rope, c, kr, tables, sl,
                            scale=scale)
    with pytest.raises(TypeError):               # q_rope and pools differ
        K1.paged_decode_mla(q_lat, q_rope.float(), c, kr, tables, sl,
                            scale=scale)
    with pytest.raises(TypeError):               # int64 lengths
        K1.paged_decode_mla(q_lat, q_rope, c, kr, tables, sl.long(),
                            scale=scale)
    odd = torch.empty(q_lat.numel() + 1, device="cuda")[1:] \
        .view(q_lat.shape).copy_(q_lat)
    with pytest.raises(ValueError):              # 4 bytes past 16-aligned
        K1.paged_decode_mla(odd, q_rope, c, kr, tables, sl, scale=scale)
    for parts in (0, K1.MAX_MLA_DECODE_PARTS + 1):
        with pytest.raises(RuntimeError):
            K1.launch_decode_mla(*ins, scale, parts)
    ins32 = _k3_inputs(rng, torch.float32, 64, 16, lens, mb)
    with pytest.raises(RuntimeError):
        K1.launch_decode_mla(*ins32, scale, 2)


def _k5_inputs(rng, dtype, Hi, Di, bs, lens, mb):
    tables, sl, nb = _decode_tables(rng, lens, bs, mb)
    kp = _cuda(rng, nb, bs, Di, dtype=dtype)
    q = _cuda(rng, len(lens), Hi, Di, dtype=dtype)
    w = torch.softmax(_cuda(rng, len(lens), Hi), -1)
    return q, w, kp, tables, sl


def _hold_scores(got, want, tol):
    dead = want <= -1e29
    assert torch.equal(got <= -1e29, dead)
    assert (got[dead] == -1e30).all()
    _hold(got.masked_fill(dead, 0.0), want.masked_fill(dead, 0.0), tol)


def _k5_lens(bs, B):
    """An idle slot, 1, bs - 1, bs, 130, then long rows up to the view's
    last position (a view of ~2300 positions: 18 chunks of 128)."""
    mb = 2300 // bs + 1
    lens = [0, 1, bs - 1, bs, 130, 1500, 2200, mb * bs - 1]
    return (lens * (B // len(lens) + 1))[:B], mb


@pytest.mark.cuda
@pytest.mark.parametrize("Hi", [16, 32, 8])
@pytest.mark.parametrize("Di", [64, 128])
@pytest.mark.parametrize("bs", [8, 16, 32])
@pytest.mark.parametrize("B", [8, 16, 32])
def test_paged_indexer_scores_tensor_cores_match_plain(Hi, Di, bs, B):
    """K5's bf16 route, the tensor-core decode body, at Hi 16 / 32 / 8 (one
    n-tile of heads) and Di 64 / 128: dead blocks NEG_INF in both, the
    live scores within the bf16 2e-2 scaled by min(1, max|plain|); one
    launch counted."""
    _need_gpu()
    rng = np.random.default_rng(Hi + Di + bs + B)
    lens, mb = _k5_lens(bs, B)
    ins = _k5_inputs(rng, torch.bfloat16, Hi, Di, bs, lens, mb)
    before = K1.paged_indexer_scores_kernel.launches
    got = K1.paged_indexer_scores_kernel(*ins)
    torch.cuda.synchronize()
    assert K1.paged_indexer_scores_kernel.launches == before + 1
    _hold_scores(got, K1.paged_indexer_scores_plain(*ins), 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol,Hi,Di", [
    # fp32 at every head count; bf16 where the tensor-core body does not
    # take the heads
    (torch.float32, 1e-4, 16, 64), (torch.float32, 1e-4, 32, 128),
    (torch.float32, 1e-4, 8, 64), (torch.float32, 1e-4, 4, 128),
    (torch.float32, 1e-4, 2, 16), (torch.bfloat16, 2e-2, 4, 128),
    (torch.bfloat16, 2e-2, 2, 16)])
def test_paged_indexer_scores_simt_routes(dtype, tol, Hi, Di):
    """K5's SIMT tile: every fp32 call, and bf16 at head counts the
    tensor-core body does not take."""
    _need_gpu()
    rng = np.random.default_rng(Hi * Di)
    lens, mb = _k5_lens(16, 8)
    ins = _k5_inputs(rng, dtype, Hi, Di, 16, lens, mb)
    _hold_scores(K1.paged_indexer_scores_kernel(*ins),
                 K1.paged_indexer_scores_plain(*ins), tol)


@pytest.mark.cuda
def test_paged_indexer_scores_refuses_what_it_cannot_take():
    """Wrong dtypes raise TypeError, misaligned q or pool ValueError, a head
    dim the kernels do not take ValueError."""
    _need_gpu()
    rng = np.random.default_rng(12)
    lens, mb = _k5_lens(16, 8)
    q, w, kp, tables, sl = _k5_inputs(rng, torch.bfloat16, 16, 64, 16, lens,
                                      mb)
    with pytest.raises(TypeError):               # q and the pool differ
        K1.paged_indexer_scores_kernel(q.float(), w, kp, tables, sl)
    with pytest.raises(TypeError):               # weights must be fp32
        K1.paged_indexer_scores_kernel(q, w.bfloat16(), kp, tables, sl)
    with pytest.raises(TypeError):               # int64 lengths
        K1.paged_indexer_scores_kernel(q, w, kp, tables, sl.long())
    odd = torch.empty(q.numel() + 1, dtype=q.dtype, device="cuda")[1:] \
        .view(q.shape).copy_(q)
    with pytest.raises(ValueError):              # 2 bytes past 16-aligned
        K1.paged_indexer_scores_kernel(odd, w, kp, tables, sl)
    with pytest.raises(ValueError):              # head dim 48
        K1.paged_indexer_scores_kernel(q[..., :48].contiguous(), w,
                                       kp[..., :48].contiguous(), tables, sl)


# ---------------------------------------------------------------------------
# K11's head-shared (Mamba-2) form
# ---------------------------------------------------------------------------

def _head_inputs(rng, B, S, H, P, N, dtype, h0_dtype):
    """zamba2's tensors: dt (B, S, H) fp32 (softplus), A (H,) fp32 with slow
    and fast heads (so a wrong chunk carry shows), x (B, S, H*P), Bc and Cc
    in dtype, h0 (B, H, P, N) in h0_dtype."""
    dt = torch.nn.functional.softplus(_cuda(rng, B, S, H) - 1.0)
    A = -torch.linspace(0.02, 2.0, H, device="cuda")
    x, Bc, Cc = (_cuda(rng, *s, dtype=dtype)
                 for s in ((B, S, H * P), (B, S, N), (B, S, N)))
    h0 = (0.5 * _cuda(rng, B, H, P, N)).to(h0_dtype)
    return dt, A, x, Bc, Cc, h0


def _hold_scan(got, want, tol=1e-5):
    """A scan's output: within tol x max(1, max|plain|) (the slow heads'
    states and outputs grow to ~20 and ~150 here, where two fp32 orders
    of the same sums differ by ~1e-4: the bound of the chunked-scan tests,
    ``test_torch_scan_chunk_numerics.py``), plus, for hT stored in bf16,
    one unit in the last place of the stored value, where both round an
    fp32 state that differs in its last bits to neighbouring values."""
    ulp = torch.finfo(got.dtype).eps if got.dtype == torch.bfloat16 else 0.
    got, want = got.float(), want.float()
    bound = tol * max(1.0, want.abs().max().item())
    err = (got - want).abs()
    assert torch.isfinite(got).all()
    assert (err <= bound + ulp * want.abs()).all(), \
        f"max abs err {err.max().item()} > {bound} (+ ulp)"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h0_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,P,N", [
    (8, 1, 80, 64, 64),       # zamba2's decode step
    (1, 300, 80, 64, 64),     # a prefill span (40 CTAs)
    (2, 77, 6, 64, 16),
    (2, 130, 3, 40, 32),      # E 120: a ragged CTA
    (1, 1, 5, 24, 16)])
def test_mamba_scan_heads_every_parts(dtype, h0_dtype, B, S, H, P, N):
    """K11's head-shared thread-a-channel body through its C entry point at
    parts 1, 2 and 16 (at most S; S 1 is the one-step kernel) and the
    wrapper (the chunked route where P is 64 and S > 1): y (fp32 on both
    sides) and hT (in h0's dtype) as ``_hold_scan`` holds them."""
    _need_gpu()
    rng = np.random.default_rng(B * S + H + N)
    ins = _head_inputs(rng, B, S, H, P, N, dtype, h0_dtype)
    want_y, want_h = K11ref.scan_heads(*ins)
    for parts in sorted({1, 2, 16} & set(range(1, S + 1))):
        y, hT = K11.launch_scan_heads(*ins, parts)
        torch.cuda.synchronize()
        assert y.shape == (B, S, H, P) and hT.dtype == h0_dtype
        _hold_scan(y, want_y)
        _hold_scan(hT, want_h)
    before = K11.mamba_scan_heads.launches
    y, hT = K11.mamba_scan_heads(*ins)
    torch.cuda.synchronize()
    assert K11.mamba_scan_heads.launches == before + 1
    _hold_scan(y, want_y)
    _hold_scan(hT, want_h)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h0_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,N", [
    (1, 256, 80, 64),         # zamba2's prefill span: 4 chunks
    (2, 77, 6, 64),           # a ragged second chunk
    (1, 130, 5, 32),
    (2, 200, 3, 16),
    (1, 1, 4, 64)])           # one step, forced onto the chunked route
def test_mamba_scan_heads_chunked_matches_plain(dtype, h0_dtype, B, S, H,
                                                N):
    """K11's head-shared chunked route (``csrc/ssd_scan.cuh``: P 64) with
    1, 3 and 8 heads a chunk CTA (a ragged last group where H is not a
    multiple) and through the wrapper (S > 1): y and hT as ``_hold_scan``
    holds them; one launch counted."""
    _need_gpu()
    rng = np.random.default_rng(B * S + H + N + 7)
    ins = _head_inputs(rng, B, S, H, 64, N, dtype, h0_dtype)
    want_y, want_h = K11ref.scan_heads(*ins)
    for heads in (1, 3, 8):
        y, hT = K11.launch_scan_heads_chunked(*ins, heads)
        torch.cuda.synchronize()
        assert y.shape == (B, S, H, 64) and hT.dtype == h0_dtype
        _hold_scan(y, want_y)
        _hold_scan(hT, want_h)
    if S > 1:
        assert K11.body(S, 64, N) == "ssd"
        before = K11.mamba_scan_heads.launches
        y, hT = K11.mamba_scan_heads(*ins)
        torch.cuda.synchronize()
        assert K11.mamba_scan_heads.launches == before + 1
        _hold_scan(y, want_y)
        _hold_scan(hT, want_h)


@pytest.mark.cuda
def test_mamba_scan_heads_parts_rule_at_zamba2():
    """zamba2's heads (P 64) take the chunked route past one step: a CTA a
    head at its prefill span (4 chunks x 80 heads: under four waves), more
    at the training shape (64 chunks x 80 heads), a divisor of 80; the
    thread-a-channel body's time split still serves the shapes it keeps
    and the parent's body it is timed against: a decode step one part, a
    batch-1 span of 1024 (40 CTAs of 128 channels on the card's SMs) cut
    into chunks."""
    _need_gpu()
    index, q = torch.cuda.current_device(), "mamba_scan_heads_resources"
    assert K11.body(1, 64, 64) == "head_step"
    assert K11.body(256, 64, 64) == "ssd"
    assert K11.body(130, 40, 32) == "head_scan"
    assert K11.chunk_heads(1, 1, 64, 1, 256, 80, index) == 1
    heads = K11.chunk_heads(0, 0, 64, 2, 2048, 80, index)
    assert 1 < heads <= K11.MAX_CHUNK_HEADS and 80 % heads == 0
    assert K11.scan_parts(1, 1, 64, 8, 1, 5120, index, q) == 1
    assert 1 < K11.scan_parts(1, 1, 64, 1, 1024, 5120, index, q) \
        <= K11.MAX_PARTS


@pytest.mark.cuda
def test_mamba_scan_heads_refuses_what_it_cannot_take():
    _need_gpu()
    rng = np.random.default_rng(11)
    ins = list(_head_inputs(rng, 2, 5, 4, 16, 16, torch.float32,
                            torch.float32))
    for parts in (0, 6, K11.MAX_PARTS + 1):   # past S = 5, past the limit
        with pytest.raises(RuntimeError):
            K11.launch_scan_heads(*ins, parts)
    bad = _head_inputs(rng, 2, 5, 4, 16, 8, torch.float32, torch.float32)
    with pytest.raises(ValueError):           # N 8: not instantiated
        K11.mamba_scan_heads(*bad)
    with pytest.raises(ValueError):           # P 16: not the chunked route's
        K11.launch_scan_heads_chunked(*ins, 1)
    wide = _head_inputs(rng, 2, 5, 4, 64, 16, torch.float32, torch.float32)
    for heads in (0, K11.MAX_CHUNK_HEADS + 1):
        with pytest.raises(RuntimeError):
            K11.launch_scan_heads_chunked(*wide, heads)
    with pytest.raises(TypeError):            # dt must be fp32
        K11.mamba_scan_heads(ins[0].bfloat16(), *ins[1:])
    with pytest.raises(ValueError):           # not contiguous
        K11.mamba_scan_heads(ins[0], ins[1], ins[2].transpose(0, 1),
                             *ins[3:])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_flash_attend_d80_grads_match_plain(dtype, tol):
    """zamba2's shared block in training: ``flash_attend`` at 32 heads of
    80 (K9's forward on the card, the plain recomputing backward), values
    and gradients against the same on K9's plain version."""
    _need_gpu()
    from repro_torch.layers import attention
    rng = np.random.default_rng(80)
    q, k, v = (_cuda(rng, 2, 150, 32, 80, dtype=dtype) for _ in range(3))
    g = _cuda(rng, 2, 150, 32, 80, dtype=dtype)

    def run():
        xs = [x.detach().requires_grad_() for x in (q, k, v)]
        out = attention.flash_attend(*xs, q_chunk=64)
        return [out.detach()] + list(torch.autograd.grad(out, xs, g))

    before = K9.flash_attention.launches
    got = run()
    assert K9.flash_attention.launches == before + 1
    wrapper, K9.flash_attention = K9.flash_attention, K9.reference
    try:
        want = run()
    finally:
        K9.flash_attention = wrapper
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        _hold(a, b, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("Sq,Sk,H,d,causal", [
    (150, 150, 32, 96, True), (150, 150, 32, 96, False),
    (448, 1500, 8, 64, False), (1, 1500, 8, 64, False)])
def test_flash_attend_new_shapes_grads_match_plain(dtype, tol, Sq, Sk, H, d,
                                                   causal):
    """phi-3-vision's attention in training (32 heads of 96, causal and
    not) and whisper-base's cross-attention (8 heads of 64, a 448-token
    text and one decode row against 1500 frames, not causal):
    ``flash_attend`` (K9's forward on the card, the plain recomputing
    backward with the same mask), values and gradients against the same
    on K9's plain version."""
    _need_gpu()
    from repro_torch.layers import attention
    rng = np.random.default_rng(Sq + d)
    q = _cuda(rng, 2, Sq, H, d, dtype=dtype)
    k, v = (_cuda(rng, 2, Sk, H, d, dtype=dtype) for _ in range(2))
    g = _cuda(rng, 2, Sq, H, d, dtype=dtype)

    def run():
        xs = [x.detach().requires_grad_() for x in (q, k, v)]
        out = attention.flash_attend(*xs, causal=causal, q_chunk=64)
        return [out.detach()] + list(torch.autograd.grad(out, xs, g))

    before = K9.flash_attention.launches
    got = run()
    assert K9.flash_attention.launches == before + 1
    wrapper, K9.flash_attention = K9.flash_attention, K9.reference
    try:
        want = run()
    finally:
        K9.flash_attention = wrapper
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        _hold(a, b, tol)
