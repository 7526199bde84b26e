"""PyTorch port: the arithmetic of K9's bf16 route, the bf16 tensor-core tile
(``csrc/mma_tile.cuh`` with ``csrc/flash_attention.cu``'s ``DenseKV``
layout), written out in plain PyTorch on the CPU and held against the JAX
package's Pallas ``flash_attention`` in interpret mode.  The CUDA tile
itself runs only on the card (``test_torch_kernels_cuda.py``,
``chip_smoke.py``); this file shows that its numerics, not only its code,
stay within the port's bounds.

The tile's walk: the G query heads of one KV head are packed for
consecutive tokens into tiles of 64 rows (row r: token r // G, head
r % G); a tile reads the keys from the first of its first query's window
(0 without a window) to its last query's position (the last key when not
causal), in rounds of 64 keys, the rounds cut into ``parts`` runs.  Each
run's (m, l, acc): q, k, v bf16 values; scores fp32 sums of exact bf16
products, scaled in fp32, then soft-capped, in the log2 domain; masked
(-inf) past the range, after the query's position when causal and
outside its window; the online softmax with m from NEG_INF; p = exp2(s -
m) unrounded into l, rounded to bf16 for PV.  The runs fold as the
combine pass folds them (out = sum 2^(m_p - M) acc_p / sum 2^(m_p - M)
l_p); a row that sees no key gets 0; the output is rounded to bf16.

The Pallas kernel keeps P in fp32 (the tile rounds it), so the two are
held at the bf16 bound, 2e-2 scaled by min(1, max|reference|), at d 64,
128 and 256, G 1 and 8, causal, window + softcap, q_offset (Sq < Sk) and
non-causal, with Sq*G and Sk not multiples of 64, rows that see no key,
at parts 1, 2 and 4.
The KV heads are repeated for the Pallas kernel as the reference's
``ops.attend`` repeats them.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import kernel as jk9
from test_torch_tile_numerics import LOG2E, NEG_INF, _bf16, _bh

ROWS, KEYS = 64, 64      # packed rows a tile, keys a round


def bf16_tile_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                        q_offset=0, parts=1):
    """K9's bf16 tile in plain PyTorch: q (B, Sq, H, d), k/v (B, Sk, KVH,
    d) bf16 values in fp32 tensors -> (B, Sq, H, d) bf16 values."""
    B, Sq, H, d = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    scale = torch.tensor(d ** -0.5, dtype=torch.float32)
    out = torch.zeros_like(q)
    for b in range(B):
        for kvh in range(KVH):
            packed = q[b, :, kvh * G:(kvh + 1) * G].reshape(Sq * G, d)
            for r0 in range(0, Sq * G, ROWS):
                r = torch.arange(r0, min(r0 + ROWS, Sq * G))
                qpos = q_offset + r // G
                lo = max(int(qpos[0]) - window + 1, 0) if window > 0 else 0
                hi = min(int(qpos[-1]), Sk - 1) if causal else Sk - 1
                rounds = (hi - lo) // KEYS + 1 if hi >= lo else 0
                runs = []
                for part in range(parts):
                    m = torch.full((len(r),), NEG_INF)
                    l = torch.zeros(len(r))
                    acc = torch.zeros(len(r), d)
                    for rd in range(rounds * part // parts,
                                    rounds * (part + 1) // parts):
                        pos = lo + rd * KEYS + torch.arange(KEYS)
                        there = pos <= hi
                        kk, vv = (torch.where(there[:, None],
                                              x[b, pos.clamp(max=Sk - 1),
                                                kvh], 0.0) for x in (k, v))
                        s = (packed[r] @ kk.T) * scale
                        if softcap > 0:
                            s = softcap * torch.tanh(s / softcap)
                        s = s * LOG2E
                        ok = there[None].expand(len(r), KEYS)
                        if causal:
                            ok = ok & (pos[None] <= qpos[:, None])
                        if window > 0:
                            ok = ok & (qpos[:, None] - pos[None] < window)
                        s = torch.where(ok, s, -torch.inf)
                        m_new = torch.maximum(m, s.amax(-1))
                        alpha = torch.exp2(m - m_new)
                        p = torch.exp2(s - m_new[:, None])
                        l = l * alpha + p.sum(-1)
                        acc = acc * alpha[:, None] + _bf16(p) @ vv
                        m = m_new
                    runs.append((m, l, acc))
                M = torch.stack([m_ for m_, _, _ in runs]).amax(0)
                w = [torch.exp2(m_ - M) for m_, _, _ in runs]
                L = sum(w_ * l_ for w_, (_, l_, _) in zip(w, runs))
                o = sum(w_[:, None] * a_ for w_, (_, _, a_) in zip(w, runs))
                o = torch.where(L[:, None] > 0,
                                o / torch.where(L > 0, L, 1.0)[:, None], 0.0)
                out[b, r // G, kvh * G + r % G] = _bf16(o)
    return out


# (d, G, Sq, Sk, options): Sq*G and Sk not multiples of 64
CASES = [
    (64, 8, 90, 90, dict(causal=True)),
    (128, 1, 100, 100, dict(causal=True, window=24, softcap=30.0)),
    (256, 8, 41, 151, dict(causal=True, q_offset=110)),
    (64, 1, 50, 150, dict(causal=False, softcap=20.0)),
    (128, 8, 30, 200, dict(causal=True, q_offset=170, window=40)),
    (256, 1, 70, 70, dict(causal=True, window=32, softcap=50.0)),
    # queries from 150 with a window of 30 over 100 keys: the last rows
    # see no key and give 0
    (64, 8, 60, 100, dict(causal=True, q_offset=120, window=30)),
]


@functools.lru_cache(maxsize=None)
def _case(i):
    """The case's bf16-valued inputs (B 1, KVH 2) and the Pallas kernel's
    output on them, built once a case."""
    d, G, Sq, Sk, kw = CASES[i]
    rng = np.random.default_rng(100 + i)
    KVH = 2

    def bf16_values(*shape):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return _bf16(x).numpy()
    q = bf16_values(1, Sq, G * KVH, d)
    k, v = bf16_values(1, Sk, KVH, d), bf16_values(1, Sk, KVH, d)
    want = np.asarray(jk9.flash_attention(
        jnp.asarray(_bh(q)), jnp.asarray(_bh(k, G)), jnp.asarray(_bh(v, G)),
        interpret=True, **kw))
    return q, k, v, want


@pytest.mark.parametrize("parts", [1, 2, 4])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_bf16_tile_attention_matches_pallas(case, parts):
    q, k, v, want = _case(case)
    kw = CASES[case][4]
    got = bf16_tile_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              parts=parts, **kw).numpy()
    got = _bh(got)
    assert np.isfinite(got).all()
    bound = 2e-2 * min(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bound, f"max abs err {err} > {bound}"
    assert err > 0.0          # the roundings are there
