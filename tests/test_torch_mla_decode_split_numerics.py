"""PyTorch port: the arithmetic of K3's bf16 route, the split-KV decode on
the MLA tensor-core tile (``csrc/paged_mla.cu``: ``mla_tile::
mla_span_kernel`` over a one-token span, then ``decode_combine_kernel``),
written out in plain PyTorch on the CPU and held against the JAX
package's Pallas ``paged_decode_mla`` in interpret mode and against the
port's plain K3.  The CUDA tile itself runs only on the card
(``test_torch_kernels_cuda.py``, ``chip_smoke.py``); this file shows that
its numerics, not only its code, stay within the port's bounds.

The tile's arithmetic at a decode step: q_lat rounded to bf16 once, as it
is staged (q_rope and the pools are bf16 values already); each row's live
keys, positions 0 .. min(seq_len, mb*bs - 1), taken in rounds of 32; the
rounds cut into ``parts`` runs as the tile cuts them (run j: rounds
[rounds*j // parts, rounds*(j+1) // parts)); within a run the online
softmax in the log2 domain from fp32 scores (exact bf16 products summed in
fp32, scaled in fp32), P rounded to bf16 for P V while l sums the
unrounded p; a run with no round keeps m = NEG_INF, l = 0, acc = 0; the
runs folded with weights exp2(m_j - M) and divided by max(l, 1e-20).

Held at the bf16 bound, 2e-2 scaled by min(1, max|reference|), at parts
1, 2, 3 and 16, over an idle slot (length 0, every table entry the trash
block), rows shorter than ``parts`` rounds (empty runs), ragged lengths
and the table's last position, blocks of 8, 16 and 32, B 6.  A run's P
is rounded to bf16 against the run's own running max, so the parts differ
from each other by bf16 rounding, not only by the fold's order; a run
with no key weighs exactly nothing.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.kernel import \
    paged_decode_mla as jax_decode_mla
from repro_torch.kernels.paged_attention import kernel as K3

LOG2E = 1.4426950408889634
NEG_INF = -1e30
L, R, H, KEYS = 512, 64, 8, 32
SCALE = 192 ** -0.5


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def mla_decode_arithmetic(q_lat, q_rope, c_pool, kr_pool, tables, seq_lens,
                          *, scale, parts, keys=KEYS):
    """K3's bf16 tile and combine in plain PyTorch: q_lat (B, H, lora) fp32,
    q_rope and the pools bf16 values, tables (B, mb), seq_lens (B,) ->
    (B, H, lora) fp32."""
    B, Hn, Ln = q_lat.shape
    bs, mb = c_pool.shape[1], tables.shape[1]
    q = torch.cat([_bf16(q_lat), q_rope.float()], dim=-1)     # staged bf16
    c_rows = c_pool.reshape(-1, Ln).float()
    kr_rows = kr_pool.reshape(-1, kr_pool.shape[-1]).float()
    out = torch.zeros_like(q_lat)
    for b in range(B):
        hi = min(int(seq_lens[b]), mb * bs - 1)
        rounds = hi // keys + 1
        ms, ls, accs = [], [], []
        for j in range(parts):
            m = torch.full((Hn,), NEG_INF)
            l = torch.zeros(Hn)
            acc = torch.zeros(Hn, Ln)
            for rd in range(rounds * j // parts, rounds * (j + 1) // parts):
                pos = torch.arange(rd * keys, (rd + 1) * keys)
                live = pos <= hi
                p_ = pos.clamp(max=hi)
                slot = tables[b, p_ // bs].long() * bs + p_ % bs
                c = torch.where(live[:, None], c_rows[slot], 0.0)
                k = torch.cat([c, torch.where(live[:, None], kr_rows[slot],
                                              0.0)], dim=-1)
                s = (q[b] @ k.T) * scale * LOG2E
                s = torch.where(live[None], s, -torch.inf)
                m_new = torch.maximum(m, s.amax(-1))
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(s - m_new[:, None])
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[:, None] + _bf16(p) @ c
                m = m_new
            ms.append(m)
            ls.append(l)
            accs.append(acc)
        m_all = torch.stack(ms)                           # (parts, H)
        w = torch.exp2(m_all - m_all.amax(0))
        lsum = (w * torch.stack(ls)).sum(0)
        acc = (w[..., None] * torch.stack(accs)).sum(0)
        out[b] = acc / lsum.clamp_min(1e-20)[:, None]
    return out


def _lens(bs):
    """An idle slot, one position, one round exactly, past it, ragged, the
    table's last position: rows of 1-8 rounds of 32 keys."""
    mb = 256 // bs
    return [0, 1, 31, 33, 100, mb * bs - 1], mb


@functools.lru_cache(maxsize=None)
def _inputs(bs):
    """Disjoint shuffled tables, row 0 an idle slot (every entry the trash
    block, the pool's last); q_lat fp32, q_rope and the pools bf16
    values."""
    lens, mb = _lens(bs)
    rng = np.random.default_rng(bs)
    B = len(lens)
    live = [0] + [n // bs + 1 for n in lens[1:]]
    nb = sum(live) + 1
    tables = np.full((B, mb), nb - 1, np.int32)
    ids, at = rng.permutation(nb - 1), 0
    for b, n in enumerate(live):
        tables[b, :n] = ids[at:at + n]
        at += n

    def bf16_values(*shape):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return _bf16(x).numpy()
    q_lat = rng.standard_normal((B, H, L)).astype(np.float32)
    return (q_lat, bf16_values(B, H, R), bf16_values(nb, bs, L),
            bf16_values(nb, bs, R), tables, np.asarray(lens, np.int32))


@functools.lru_cache(maxsize=None)
def _pallas(bs):
    return np.asarray(jax_decode_mla(*map(jnp.asarray, _inputs(bs)),
                                     scale=SCALE, interpret=True))


def _held(got, want):
    bound = 2e-2 * min(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bound, f"max abs err {err} > {bound}"
    return err


@pytest.mark.parametrize("bs", [8, 16, 32])
@pytest.mark.parametrize("parts", [1, 2, 3, 16])
def test_mla_decode_split_matches_pallas_and_plain(bs, parts):
    ins = [torch.from_numpy(x) for x in _inputs(bs)]
    got = mla_decode_arithmetic(*ins, scale=SCALE, parts=parts).numpy()
    assert np.isfinite(got).all()                     # the idle slot too
    want = _pallas(bs)
    _held(got, want)
    plain = K3.paged_decode_mla_plain(*ins, scale=SCALE).numpy()
    _held(got, plain)


def test_short_rows_leave_parts_without_keys():
    """At parts 16 the one-round rows (lengths 0, 1, 31: one round of 32
    keys) leave 15 runs empty, and an empty run weighs exactly nothing:
    the row's output is its one run's."""
    ins = [torch.from_numpy(x) for x in _inputs(16)]
    lens = ins[-1]
    assert int((lens // KEYS + 1 < 16).sum()) == len(lens)
    split = mla_decode_arithmetic(*ins, scale=SCALE, parts=16)
    whole = mla_decode_arithmetic(*ins, scale=SCALE, parts=1)
    short = lens < KEYS
    assert torch.equal(split[short], whole[short])
