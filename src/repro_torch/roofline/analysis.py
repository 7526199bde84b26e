"""Roofline terms of a step on one H100, from its counted run on meta.

Port of ``repro.roofline.analysis`` with the card's constants in the place
of the TPU's (the H100 SXM data sheet, the constants of ``PERF.md``'s
kernel bounds):

  compute_s    = FLOPs_per_device / 989e12        (bf16 dense peak)
  memory_s     = bytes_per_device / 3.35e12       (HBM3)
  collective_s = collective wire bytes / 450e9    (NVLink, each direction)

The FLOPs, bytes and collectives come from ``roofline.counting`` (the
step run op by op on ``meta`` tensors), where the reference's come from
the partitioned HLO.  A collective's wire bytes are its buffer bytes
times the ring multiplier ``WIRE_MULT`` (an all-reduce moves ~2x its
buffer) times (n - 1) / n for its n ranks: a group of one rank moves
nothing.  ``active_param_count`` and ``model_flops`` (the 6·N·D / 2·N·D
count of useful work) are the reference's arithmetic, unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Tuple

from repro_torch.layers.ssm import d_inner, dt_rank
from repro_torch.roofline.counting import BYTES_KIND, Counts

PEAK_FLOPS = 989e12       # bf16 dense FLOP/s, H100 SXM
HBM_BW = 3.35e12          # bytes/s, HBM3
LINK_BW = 450e9           # bytes/s, NVLink 4, each direction

# ring-algorithm wire multipliers (bytes moved per device / buffer bytes)
WIRE_MULT = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


def collective_bytes(records: Iterable[Tuple[str, int, int]]
                     ) -> Dict[str, float]:
    """Per-device wire bytes per collective type from (op, buffer bytes,
    ranks) records, and their counts under ``_counts``."""
    out: Dict[str, float] = {}
    count: Dict[str, int] = {}
    for op, nbytes, ranks in records:
        out[op] = out.get(op, 0.0) + nbytes * WIRE_MULT[op] * (ranks - 1) \
            / ranks
        count[op] = count.get(op, 0) + 1
    out["_counts"] = count  # type: ignore
    return out


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collectives: Dict[str, float]
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    useful_ratio: float           # MODEL_FLOPS / (counted FLOPs × chips)
    peak_memory_bytes: int        # per-device arguments + temporaries
    argument_bytes: int
    temp_bytes: int
    output_bytes: int
    bytes_kind: str = BYTES_KIND

    def to_dict(self):
        return dataclasses.asdict(self)


def analyze(counts: Counts, *, arch: str, shape: str, mesh_name: str,
            chips: int, model_flops: float) -> Roofline:
    """Roofline terms from a step's counts (``counting.count``)."""
    colls = collective_bytes(counts.collectives)
    cbytes = float(sum(v for k, v in colls.items() if k != "_counts"))
    compute_s = counts.flops / PEAK_FLOPS
    memory_s = counts.bytes / HBM_BW
    collective_s = cbytes / LINK_BW
    dominant = max((("compute", compute_s), ("memory", memory_s),
                    ("collective", collective_s)), key=lambda kv: kv[1])[0]
    total = counts.flops * chips
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_device=counts.flops, bytes_per_device=counts.bytes,
        collective_bytes_per_device=cbytes, collectives=colls,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, model_flops=model_flops,
        useful_ratio=(model_flops / total) if total else 0.0,
        peak_memory_bytes=int(counts.peak_bytes),
        argument_bytes=int(counts.argument_bytes),
        temp_bytes=int(counts.peak_bytes - counts.argument_bytes),
        output_bytes=int(counts.output_bytes))


# ---------------------------------------------------------------------------
# MODEL_FLOPS estimates (6·N·D train, 2·N·D forward-only)
# ---------------------------------------------------------------------------

def active_param_count(cfg) -> float:
    """Matmul parameters activated per token (MoE: top-k + shared experts),
    excluding embeddings/unembed (standard 6ND convention)."""
    D = cfg.d_model
    n = 0.0
    L = cfg.num_layers
    # attention
    if cfg.family in ("ssm",):
        att = 0.0
    elif cfg.attention_type == "mla":
        m = cfg.mla
        qk = m.qk_nope_dim + m.qk_rope_dim
        att = (D * m.q_lora_dim + m.q_lora_dim * cfg.num_heads * qk
               + D * (m.kv_lora_dim + m.qk_rope_dim)
               + m.kv_lora_dim * cfg.num_heads * (m.qk_nope_dim
                                                  + m.v_head_dim)
               + cfg.num_heads * m.v_head_dim * D)
    else:
        att = (D * cfg.num_heads * cfg.head_dim * 2
               + D * cfg.num_kv_heads * cfg.head_dim * 2)
    if cfg.dsa is not None:
        att += D * (cfg.dsa.index_heads * cfg.dsa.index_head_dim
                    + cfg.dsa.index_head_dim + cfg.dsa.index_heads)
    # mlp per layer
    gate = 3 if cfg.mlp_activation == "swiglu" else 2
    if cfg.num_experts > 0:
        k = cfg.experts_per_token + cfg.num_shared_experts
        moe = k * gate * D * cfg.moe_d_ff + D * cfg.num_experts
        dense_mlp = gate * D * cfg.d_ff
        n += cfg.first_k_dense * (att + dense_mlp)
        n += (L - cfg.first_k_dense) * (att + moe)
    elif cfg.family == "ssm":
        E = d_inner(cfg)
        per = (D * 2 * E + E * (dt_rank(cfg) + 2 * cfg.ssm_state)
               + dt_rank(cfg) * E + E * D)
        n += L * per
    elif cfg.family == "hybrid":
        E = d_inner(cfg)
        H = E // cfg.ssm_head_dim
        per = D * (2 * E + 2 * cfg.ssm_state + H) + E * D
        n += L * per
        # ONE shared attention block counts once per invocation
        inv = L // cfg.hybrid_attn_every
        n += inv * (att + gate * D * cfg.d_ff)
    else:
        n += L * (att + gate * D * cfg.d_ff)
    if cfg.family == "audio":
        n += cfg.encoder_layers * (att + gate * D * cfg.d_ff)
        n += L * (D * cfg.num_heads * cfg.head_dim * 2
                  + D * cfg.num_kv_heads * cfg.head_dim * 2)  # cross attn
    return n


def model_flops(cfg, shape) -> float:
    N = active_param_count(cfg)
    tokens = shape.global_batch * (shape.seq_len if shape.kind == "train"
                                   else (shape.seq_len if shape.kind ==
                                         "prefill" else 1))
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * N * tokens
