// Paged absorbed-MLA attention for Hopper (sm_90a): K3 decode and K4 span
// prefill, both reading the latent pools IN PLACE through the block table.
//
// Replaces the TPU kernels of the JAX package:
//   K3  src/repro/kernels/paged_attention/kernel.py   paged_decode_mla
//   K4  src/repro/kernels/paged_attention/prefill.py  paged_prefill_mla
//
// Contract (the same as the Pallas kernels): token position p of row b lives
// at (tables[b, p / bs], p % bs) of c_pool (nb, bs, lora) and kr_pool
// (nb, bs, rope).  Packed query row r of batch row b is head h = r % H of
// span token i = r / H at absolute position starts[b] + i (decode: S = 1 and
// starts = seq_lens).  All heads share the one latent KV.  A query attends
// every position k_pos <= q_pos with score
//   s = (q_lat . c + q_rope . kr) * scale     (scale = (qk_nope+qk_rope)^-1/2)
// folded with an fp32 online softmax, and the output is probs . c: the
// latent is also the value.  q_lat and the output are fp32 (the absorbed
// query q_nope . W^UK is built in fp32); q_rope and the pools are in the
// model's dtype.  The final division clamps l at 1e-20 so a trash row
// (length 0) still gives a finite output.
//
// What bounds it on this card: per query row and key it does
// 2*(lora+rope) + 2*lora = 2176 flops (GLM-5: lora 512, rope 64) against
// 1152 bytes of bf16 latent shared by all H heads, so at H = 64 a decode
// step does ~120 flops per latent byte.  That is below the ~295 flop/byte
// ridge of the tensor cores, so K3 (decode) is bound by its bytes: the
// live latent read once, q_lat (fp32) in and out_lat (fp32) out; K4 at a
// long span by its operations.  Either way the products belong on the
// tensor cores: the CUDA cores' fp32 FMAs (67 TFLOP/s at best) would make
// even a decode step arithmetic-bound.
//
// Two bodies, chosen by dtype.  bf16 (the serving path: every decode step
// without speculation, every prefill chunk and, with speculation, every
// verify span) runs the tensor-core tile below (mla_tile: mma.sync, the
// latent in a cp.async ring, the key range split over `parts` CTAs and
// folded by a combine pass).  A decode step is a span of one token
// (starts = seq_lens): at H 64 a row's heads are exactly one 64-row tile,
// so every head reads the row's latent from one copy in shared memory,
// once; the row's key rounds are split over up to kDecodeMaxParts CTAs
// (split-KV, as K1's decode_split), since B 8 rows give only 8 tiles for
// 132 SMs, and K3's own combine kernel folds them (a CTA a head and row,
// every part's loads in flight).  The wrapper picks the parts from the
// shapes alone, never from seq_lens (a device-to-host copy).  A part
// whose rounds lie past its row's end (a short row, many parts) writes
// m = NEG_INF, l = 0 and no read of the pool: the combine gives it zero
// weight.  fp32 (the exact parity runs) runs the SIMT body:
//   * one CTA per (16-row tile, batch row) walks only that tile's live
//     blocks itself: it loads its own table entries and start and stops at
//     the block of its last query position (causal early exit per tile), so
//     traffic is O(live tokens) and nothing is gathered into a padded view;
//   * a round stages 32 positions of [c | kr] in shared memory; the same
//     staged c serves the scores and the PV product, so each latent byte is
//     read from device memory once per tile; every load of a round is
//     issued before any is used;
//   * the Pallas kernels keep the whole (H, lora) or (S*H, lora) fp32
//     accumulator in VMEM (128 KB per decode row, 32 MB for a 256-token
//     span at H = 64); here the packed rows are tiled 16 at a time and the
//     16 x lora accumulator lives in registers, each thread owning lora/256
//     columns of every row;
//   * scores: warp w owns rows 2w and 2w+1 and lane t position t of the
//     round, so the warp holds whole score rows and runs their online
//     softmax in registers with shuffles, without another barrier.
// Not done yet (later work): wgmma and TMA for the tile.
//
// Interface: plain C, loaded with ctypes.  Each entry point returns the
// cudaError_t of its launch (0 on success); it launches on the given stream,
// does not synchronise and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "mma_tile.cuh"

namespace {

// ---------------------------------------------------------------------------
// The fp32 SIMT body (K3 and K4 in fp32)
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 2 * kWarps;  // packed query rows per CTA (2 per warp)
constexpr int kTokens = 32;        // latent positions per round (1 per lane)
constexpr int kLdP = kTokens + 4;  // probability row stride (floats)
constexpr float kNegInf = -1e30f;  // the reference kernels' NEG_INF

__device__ inline float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Shared-memory row stride (floats) of the staged [q_lat | q_rope] rows and
// [c | kr] positions.  +4 keeps 16-byte alignment for the float4 reads and
// puts the 8 rows a quarter-warp reads on distinct banks.
template <int L, int R>
constexpr int kLd = L + R + 4;

template <int L, int R>
constexpr size_t smem_floats() {
  return (size_t)kRows * kLd<L, R>       // Qs
         + (size_t)kTokens * kLd<L, R>   // Ks: [c | kr] per position
         + (size_t)kRows * kLdP          // Ps
         + 3 * (size_t)kRows;            // running max, sum, rescale
}

template <int L, int R>
__global__ void __launch_bounds__(kThreads)
paged_mla_kernel(const float* __restrict__ q_lat,
                 const float* __restrict__ q_rope,
                 const float* __restrict__ c_pool,
                 const float* __restrict__ kr_pool,
                 const int* __restrict__ tables,
                 const int* __restrict__ starts, float* __restrict__ out,
                 int SH, int H, int mb, int bs, float scale) {
  constexpr int D = L + R;           // length of a score's dot product
  constexpr int LD = kLd<L, R>;
  static_assert(L % 4 == 0 && R % 4 == 0, "vector width");
  constexpr int VL = L / 4;          // float4s of c per position
  constexpr int VPK = D / 4;         // ... of [c | kr] per position
  static_assert(kTokens * VPK % kThreads == 0, "staging split");
  constexpr int NV = kTokens * VPK / kThreads;  // per thread and round
  static_assert(L % kThreads == 0, "columns per thread");
  constexpr int CPT = L / kThreads;
  static_assert(kTokens == 32, "one position per lane");

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kRows * LD;
  float* Ps = Ks + kTokens * LD;
  float* Ms = Ps + kRows * kLdP;
  float* Ls = Ms + kRows;
  float* As = Ls + kRows;

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int r0 = blockIdx.x * kRows;
  const int b = blockIdx.y;
  const int rows = min(kRows, SH - r0);
  const int start = starts[b];
  const int* table = tables + (size_t)b * mb;
  const size_t row0 = (size_t)b * SH + r0;  // packed row index

  // stage the tile's queries [q_lat | q_rope]; rows past `rows` are zero
  // and masked, so they fold nothing and are never written
  for (int i = tid; i < kRows * (D / 4); i += kThreads) {
    const int r = i / (D / 4), e = (i % (D / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows)
      v = e < L ? ld4(q_lat + (row0 + r) * L + e)
                : ld4(q_rope + (row0 + r) * R + (e - L));
    *reinterpret_cast<float4*>(Qs + r * LD + e) = v;
  }
  for (int r = tid; r < kRows; r += kThreads) {
    Ms[r] = kNegInf;
    Ls[r] = 0.f;
  }

  float acc[kRows][CPT];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  // live range of the tile: position 0 .. the tile's last query position
  const int hi = min(start + (r0 + rows - 1) / H, mb * bs - 1);
  // this warp's two score rows and their positions
  const int ra = 2 * warp, rb = ra + 1;
  const int qpa = start + (r0 + ra) / H, qpb = start + (r0 + rb) / H;

  // every load of the round at c0 is issued before any is used; past hi a
  // thread stages zeros, so the p = 0 padding of a short round never meets
  // stale shared memory.  [c | kr] of position t lands at Ks[t*LD ..
  // t*LD + D): float4 v of the position goes to offset 4v whether it came
  // from c or from kr
  float4 raw[NV];
  auto fetch = [&](int c0) {
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int i = tid + u * kThreads;
      const int t = i / VPK, v = i % VPK;
      const int pos = c0 + t;
      if (pos <= hi) {
        const size_t slot = (size_t)table[pos / bs] * bs + pos % bs;
        raw[u] = v < VL ? ld4(c_pool + slot * L + v * 4)
                        : ld4(kr_pool + slot * R + (v - VL) * 4);
      } else {
        raw[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int i = tid + u * kThreads;
      const int t = i / VPK, v = i % VPK;
      *reinterpret_cast<float4*>(Ks + t * LD + v * 4) = raw[u];
    }
  };
  // one score row of the warp through the online softmax (the reference's
  // update: masked entries count as NEG_INF in the max and contribute 0)
  auto fold_row = [&](int r, float s, bool ok) {
    float mx = ok ? s : -INFINITY;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_prev = Ms[r];
    const float m_new = fmaxf(m_prev, mx);
    const float p = ok ? expf(s - m_new) : 0.f;
    float l = p;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, o);
    Ps[r * kLdP + lane] = p;
    if (lane == 0) {  // every lane read Ms[r] before the shuffles above
      const float alpha = expf(m_prev - m_new);
      Ls[r] = Ls[r] * alpha + l;
      Ms[r] = m_new;
      As[r] = alpha;
    }
  };

  for (int c0 = 0; c0 <= hi; c0 += kTokens) {
    const int n = min(kTokens, hi - c0 + 1);
    fetch(c0);
    __syncthreads();  // last round's readers of Ks/Ps/As are done
    stash();
    __syncthreads();

    // scores of rows ra, rb against position `lane` of the round: the
    // query rows are broadcast, the position rows conflict-free
    {
      const float4* kv = reinterpret_cast<const float4*>(Ks + lane * LD);
      const float4* qa = reinterpret_cast<const float4*>(Qs + ra * LD);
      const float4* qb = reinterpret_cast<const float4*>(Qs + rb * LD);
      float da = 0.f, db = 0.f;
#pragma unroll 8
      for (int e4 = 0; e4 < D / 4; ++e4) {
        const float4 k = kv[e4];
        const float4 x = qa[e4];
        const float4 y = qb[e4];
        da = fmaf(x.x, k.x, da);
        da = fmaf(x.y, k.y, da);
        da = fmaf(x.z, k.z, da);
        da = fmaf(x.w, k.w, da);
        db = fmaf(y.x, k.x, db);
        db = fmaf(y.y, k.y, db);
        db = fmaf(y.z, k.z, db);
        db = fmaf(y.w, k.w, db);
      }
      const int kp = c0 + lane;
      const bool live = lane < n;
      fold_row(ra, da * scale, live && ra < rows && kp <= qpa);
      fold_row(rb, db * scale, live && rb < rows && kp <= qpb);
    }
    __syncthreads();

    // acc = acc * alpha + P @ C over this round's positions (the staged c
    // is the value)
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float alpha = As[i];
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] *= alpha;
    }
    for (int t4 = 0; t4 < n; t4 += 4) {
      float v[4][CPT];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int j = 0; j < CPT; ++j)
          v[u][j] = Ks[(t4 + u) * LD + tid + j * kThreads];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 p = reinterpret_cast<const float4*>(Ps + i * kLdP)[t4 / 4];
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          float a = acc[i][j];
          a = fmaf(p.x, v[0][j], a);
          a = fmaf(p.y, v[1][j], a);
          a = fmaf(p.z, v[2][j], a);
          a = fmaf(p.w, v[3][j], a);
          acc[i][j] = a;
        }
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    if (i < rows) {
      const float l = fmaxf(Ls[i], 1e-20f);
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        out[(row0 + i) * L + tid + j * kThreads] = acc[i][j] / l;
    }
  }
}

// ---------------------------------------------------------------------------
// The bf16 body on the tensor cores (K4's spans, K3's decode steps)
// ---------------------------------------------------------------------------
//
// GLM-5's span (H 64 heads reading one latent, dk 576 = lora 512 + rope 64,
// dv 512) is arithmetic: 2176 flops a row and key.  This body runs both
// products on mma.sync (m16n8k16, bf16 in, fp32 accumulate) with the
// helpers, the cp.async ring and the split-and-combine pass of
// mma_tile.cuh; what differs from that tile is the width:
//   * dv 512 would need a 16 x 512 fp32 accumulator a warp (256 registers)
//     in mma_tile's one-warp-a-16-rows layout.  Here a CTA of 16 warps owns
//     kRows = 64 packed rows, and the warps regroup between the products:
//     QK^T runs as 4 row groups x 4 slices of the 576 dims (9 k-steps of
//     16 each; a warp's Q fragment is loaded once a k-step and serves the
//     round's 4 key tiles), whose partial scores meet in shared memory; the
//     softmax runs 8 threads a row over the summed scores, keeps each row's
//     running (m, l) in those threads' registers and writes P once, as
//     bf16, with the rescale alpha; PV runs as 2 row groups of 32 rows x 8
//     column groups of 64 (each V fragment serves two 16-row tiles), so a
//     warp holds a 32 x 64 accumulator (64 registers);
//   * V is the staged key rows' first 512 columns: one cp.async copy of
//     [c | kr] a key serves both products, as in the SIMT body;
//   * shared memory: Q (64 x 584 bf16, 74.75 KB, q_lat rounded to bf16 once
//     while staged), kStages rounds of kKeys keys (32 x 584 bf16 each), the
//     partial scores (fp32) and P: 1 CTA an SM.  Packed row r of a tile is
//     token r / H, head r % H (H 64: one token; H 16: 4 tokens, the causal
//     mask per row);
//   * the span's tiles (256 at the serve chunk of 256 tokens) fill the card;
//     a verify span (B 8 x S 4 x H 64: 32 tiles) splits each tile's key
//     rounds over `parts` CTAs (wrapper: build.key_split), folded by
//     mma_tile's combine pass into the fp32 output;
//   * a decode step (K3: S 1, a tile a row at H 64) splits each row's
//     rounds over up to kDecodeMaxParts CTAs (wrapper: mla_decode_parts),
//     folded by decode_combine_kernel below; at H 16 a tile holds 16 live
//     rows of 64;
//   * a part with no round (more parts than the row has rounds) writes
//     its (m, l, acc) = (NEG_INF, 0, 0) without staging anything;
//   * numerics: QK^T of bf16 q_lat / q_rope against the bf16 latent, exact
//     products in fp32 accumulators; scores scaled in fp32; the softmax in
//     the log2 domain (masked: -inf, p = 0); P rounded to bf16 for PV (as
//     K2 / K8); out = acc / max(l, 1e-20) in fp32.
// The tile sizes are compile-time knobs (REPRO_MLA_KEYS 16 / 32,
// REPRO_MLA_STAGES 2 / 3) so tile_study.py can build and time the others.

#ifndef REPRO_MLA_KEYS
#define REPRO_MLA_KEYS 32
#endif
#ifndef REPRO_MLA_STAGES
#define REPRO_MLA_STAGES 2
#endif

namespace mla_tile {

using mma_tile::bf16;
using mma_tile::cp_async16;
using mma_tile::cp_async_commit;
using mma_tile::cp_async_wait;
using mma_tile::kLog2e;
using mma_tile::kNegInf;
using mma_tile::kNoKey;
using mma_tile::ldsm_x4;
using mma_tile::ldsm_x4_trans;
using mma_tile::mma16816;
using mma_tile::store_pair;
using mma_tile::ws_rows;

constexpr int kL = 512, kR = 64, kD = kL + kR;
constexpr int kRows = mma_tile::kRows;   // 64 packed rows a CTA
constexpr int kKeys = REPRO_MLA_KEYS;    // keys a round
constexpr int kStages = REPRO_MLA_STAGES;
constexpr int kSlots = kStages + 1;      // key tables in flight
constexpr int kThreads = 512;            // 16 warps
constexpr int kDimGroups = 4;            // QK^T: slices of the 576 dims
constexpr int kSteps = kD / 16 / kDimGroups;   // k-steps a slice (9)
constexpr int kPvCols = 64;              // PV: columns a warp
constexpr int kLdK = kD + 8;             // bf16: Q and [c | kr] rows
constexpr int kLdS = kKeys + 4;          // fp32: partial scores
constexpr int kLdP = kKeys + 8;          // bf16: P rows
constexpr int kPerThread = kKeys * kRows / kThreads;  // softmax entries
static_assert(kD % (16 * kDimGroups) == 0 && kKeys % 16 == 0 &&
              kPerThread >= 1 && 8 * kPerThread == kKeys, "tile shape");
static_assert(kStages >= 2, "a round lands while the last computes");

constexpr size_t kSmem =
    ((size_t)kRows * kLdK + (size_t)kStages * kKeys * kLdK) * 2   // Q, K/V
    + (size_t)kDimGroups * kRows * kLdS * 4                       // S parts
    + (size_t)kRows * kLdP * 2                                    // P
    + (size_t)3 * kRows * 4                                       // alpha, m, l
    + (size_t)kSlots * 2 * kKeys * 4;                             // key table

// the rows and keys of a batch row's span, for the combine pass too
struct LatentSpan {
  static constexpr bool kMean = false;   // a row with no key gets 0
  const int* tables;
  const int* starts;
  int SH, H, mb, bs;
  __device__ int rows(int, int) const { return SH; }
  __device__ size_t out_row(int y, int, int r) const {
    return (size_t)y * SH + r;
  }
};

__global__ void __launch_bounds__(kThreads, 1)
mla_span_kernel(const float* __restrict__ q_lat,
                const bf16* __restrict__ q_rope,
                const bf16* __restrict__ c_pool,
                const bf16* __restrict__ kr_pool,
                float* __restrict__ out, float* __restrict__ ws,
                LatentSpan layout, int parts, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kRows * kLdK;                        // [kStages][kKeys]
  float* Sp = reinterpret_cast<float*>(Ks + kStages * kKeys * kLdK);
  bf16* Ps = reinterpret_cast<bf16*>(Sp + kDimGroups * kRows * kLdS);
  float* As = reinterpret_cast<float*>(Ps + kRows * kLdP);
  float* Ms = As + kRows;
  float* Ls = Ms + kRows;
  int* Kpos = reinterpret_cast<int*>(Ls + kRows);      // [kSlots][kKeys]
  int* Krow = Kpos + kSlots * kKeys;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int ntiles = gridDim.x / parts;
  const int part = blockIdx.x % parts;
  const int x = ntiles - 1 - blockIdx.x / parts;   // the longest tiles first
  const int b = blockIdx.y;
  const int H = layout.H, bs = layout.bs;
  const int r0 = x * kRows;
  const int rows = min(kRows, layout.SH - r0);
  const int pos0 = layout.starts[b];
  const int* table = layout.tables + (size_t)b * layout.mb;
  const size_t row0 = (size_t)b * layout.SH + r0;
  const int col0 = warp / 2 * kPvCols + (lane % 4) * 2;   // PV's columns
  // the workspace of this part (parts > 1): (m, l) and acc of its rows
  const size_t tile = (size_t)b * ntiles + x;
  const size_t all = (size_t)ntiles * gridDim.y;
  float* ml = ws + ws_rows(tile, parts, part) * 2;
  float* wacc = ws + all * parts * kRows * 2 + ws_rows(tile, parts, part) * kL;

  // every key from position 0 to the tile's last query, in rounds
  const int hi = min(pos0 + (r0 + rows - 1) / H, layout.mb * bs - 1);
  const int rounds = hi / kKeys + 1;
  const int rb = rounds * part / parts, re = rounds * (part + 1) / parts;
  if (rb == re) {   // no round (parts > 1): a part the combine weighs 0
    for (int r = tid; r < rows; r += kThreads) {
      ml[2 * r] = kNegInf;
      ml[2 * r + 1] = 0.f;
    }
    for (int i = tid; i < rows * (kL / 4); i += kThreads)
      *reinterpret_cast<float4*>(wacc + (size_t)i * 4) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }

  // round rd's key table (slot (rd - rb) % kSlots): position (kNoKey past
  // hi) and latent row of each key
  auto look_up = [&](int rd) {
    if (tid >= kKeys || rd >= re) return;
    const int t = rd * kKeys + tid;
    const int slot = (rd - rb) % kSlots;
    Kpos[slot * kKeys + tid] = t <= hi ? t : kNoKey;
    Krow[slot * kKeys + tid] =
        t <= hi ? __ldg(table + t / bs) * bs + t % bs : 0;
  };
  // round rd's [c | kr] rows into stage (rd - rb) % kStages; a key that is
  // not there is zero-filled
  auto issue = [&](int rd) {
    if (rd >= re) return;
    const int* pos = Kpos + ((rd - rb) % kSlots) * kKeys;
    const int* row = Krow + ((rd - rb) % kSlots) * kKeys;
    bf16* st = Ks + ((rd - rb) % kStages) * kKeys * kLdK;
    constexpr int kChunks = kD / 8;   // 64 of c, 8 of kr
    for (int i = tid; i < kKeys * kChunks; i += kThreads) {
      const int j = i / kChunks, c = (i % kChunks) * 8;
      const bool ok = pos[j] != kNoKey;
      const bf16* src = c < kL ? c_pool + (size_t)row[j] * kL + c
                               : kr_pool + (size_t)row[j] * kR + (c - kL);
      cp_async16(st + j * kLdK + c, src, ok);
    }
  };

  // the first rounds' keys go out first, so that they land while the
  // queries are staged: q_rope by cp.async (in the first group), q_lat
  // rounded to bf16 on the way in, kQLoads float4 loads in flight a
  // thread; rows past `rows` are zero and never written
  for (int s = 0; s < kStages; ++s) look_up(rb + s);
  __syncthreads();
  for (int i = tid; i < kRows * (kR / 8); i += kThreads) {
    const int r = i / (kR / 8), c = (i % (kR / 8)) * 8;
    const bool ok = r < rows;
    cp_async16(Qs + r * kLdK + kL + c,
               q_rope + (ok ? row0 + r : 0) * kR + c, ok);
  }
  for (int s = 0; s < kStages - 1; ++s) {
    issue(rb + s);
    cp_async_commit();
  }
  constexpr int kQLoads = 8;
  static_assert(kRows * (kL / 4) % (kThreads * kQLoads) == 0, "q staging");
  for (int i0 = tid; i0 < kRows * (kL / 4); i0 += kThreads * kQLoads) {
    float4 f[kQLoads];
#pragma unroll
    for (int u = 0; u < kQLoads; ++u) {
      const int i = i0 + u * kThreads, r = i / (kL / 4);
      f[u] = r < rows ? *reinterpret_cast<const float4*>(
                            q_lat + (row0 + r) * kL + (i % (kL / 4)) * 4)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kQLoads; ++u) {
      const int i = i0 + u * kThreads;
      bf16* q = Qs + (i / (kL / 4)) * kLdK + (i % (kL / 4)) * 4;
      store_pair(q, f[u].x, f[u].y);
      store_pair(q + 2, f[u].z, f[u].w);
    }
  }

  // QK^T warps: row group qg, dim slice dg; PV warps: row group pg (32
  // rows), column group cg; softmax threads: row sr, keys sj..
  const int qg = warp % 4, dg = warp / 4;
  const int pg = warp % 2, cg = warp / 2;
  const int sr = tid / 8, sj = (tid % 8) * kPerThread;
  const int s_qpos = pos0 + (r0 + sr) / H;
  const float scale2 = scale * kLog2e;
  float m_run = kNegInf, l_run = 0.f;   // row sr's, in all 8 threads
  float acc[2][kPvCols / 8][4];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int n = 0; n < kPvCols / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][n][e] = 0.f;

  for (int rd = rb; rd < re; ++rd) {
    const int slot = (rd - rb) % kSlots;
    const bf16* Kst = Ks + ((rd - rb) % kStages) * kKeys * kLdK;
    cp_async_wait<kStages - 2>();
    // round rd has landed, its key table and the next ones are written, and
    // every reader of the stage refilled below (round rd - 1's) is done
    __syncthreads();
    issue(rd + kStages - 1);
    cp_async_commit();
    look_up(rd + kStages);

    // partial S = Q K^T over this warp's 144 dims: 16 rows x kKeys keys
    {
      float s[kKeys / 8][4];
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        const int kk = (dg * kSteps + ks) * 16;
        uint32_t a[4];
        ldsm_x4(a, Qs + (qg * 16 + lane % 16) * kLdK + kk + (lane / 16) * 8);
#pragma unroll
        for (int n2 = 0; n2 < kKeys / 16; ++n2) {
          uint32_t bb[4];
          ldsm_x4(bb, Kst + (n2 * 16 + lane % 8 + (lane / 16) * 8) * kLdK
                          + kk + ((lane / 8) % 2) * 8);
          mma16816(s[2 * n2], a, bb[0], bb[1]);
          mma16816(s[2 * n2 + 1], a, bb[2], bb[3]);
        }
      }
      float* sp = Sp + (dg * kRows + qg * 16 + lane / 4) * kLdS
                  + (lane % 4) * 2;
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n) {
        *reinterpret_cast<float2*>(sp + n * 8) = make_float2(s[n][0], s[n][1]);
        *reinterpret_cast<float2*>(sp + 8 * kLdS + n * 8) =
            make_float2(s[n][2], s[n][3]);
      }
    }
    __syncthreads();   // the partial scores are in

    // the online softmax of row sr over its kPerThread keys: the four
    // slices summed, scaled, masked; max and sum over the row's 8 threads
    {
      const int* kp = Kpos + slot * kKeys;
      float sv[kPerThread];
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < kPerThread; ++u) {
        float x = 0.f;
#pragma unroll
        for (int g = 0; g < kDimGroups; ++g)
          x += Sp[(g * kRows + sr) * kLdS + sj + u];
        sv[u] = kp[sj + u] <= s_qpos ? x * scale2 : -INFINITY;
        mx = fmaxf(mx, sv[u]);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_run, mx);
      const float alpha = exp2f(m_run - m_new);
      m_run = m_new;
      float ls = 0.f;
#pragma unroll
      for (int u = 0; u < kPerThread; u += 2) {
        const float p0 = exp2f(sv[u] - m_new), p1 = exp2f(sv[u + 1] - m_new);
        ls += p0 + p1;
        store_pair(Ps + sr * kLdP + sj + u, p0, p1);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        ls += __shfl_xor_sync(0xffffffffu, ls, o);
      l_run = l_run * alpha + ls;
      if (tid % 8 == 0) As[sr] = alpha;
    }
    __syncthreads();   // P and alpha are in

    // acc = acc * alpha + P V over this warp's 32 rows x 64 columns
    {
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int r = pg * 32 + t * 16 + lane / 4;
        const float a0 = As[r], a1 = As[r + 8];
#pragma unroll
        for (int n = 0; n < kPvCols / 8; ++n) {
          acc[t][n][0] *= a0;
          acc[t][n][1] *= a0;
          acc[t][n][2] *= a1;
          acc[t][n][3] *= a1;
        }
      }
      const bf16* Vst = Kst + cg * kPvCols;
#pragma unroll
      for (int kt = 0; kt < kKeys / 16; ++kt) {
        uint32_t a[2][4];
#pragma unroll
        for (int t = 0; t < 2; ++t)
          ldsm_x4(a[t], Ps + (pg * 32 + t * 16 + lane % 16) * kLdP + kt * 16
                             + (lane / 16) * 8);
#pragma unroll
        for (int n2 = 0; n2 < kPvCols / 16; ++n2) {
          uint32_t bb[4];
          ldsm_x4_trans(bb, Vst + (kt * 16 + lane % 8 + ((lane / 8) % 2) * 8)
                                      * kLdK + n2 * 16 + (lane / 16) * 8);
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            mma16816(acc[t][2 * n2], a[t], bb[0], bb[1]);
            mma16816(acc[t][2 * n2 + 1], a[t], bb[2], bb[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  if (tid % 8 == 0) {
    Ms[sr] = m_run;
    Ls[sr] = l_run;
  }
  __syncthreads();

  if (parts > 1) {   // this part's (m, l, acc) for the combine pass
    for (int r = tid; r < rows; r += kThreads) {
      ml[2 * r] = Ms[r];
      ml[2 * r + 1] = Ls[r];
    }
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = pg * 32 + t * 16 + lane / 4 + 8 * i;
        if (r >= rows) continue;
#pragma unroll
        for (int n = 0; n < kPvCols / 8; ++n)
          *reinterpret_cast<float2*>(wacc + (size_t)r * kL + col0 + n * 8) =
              make_float2(acc[t][n][2 * i], acc[t][n][2 * i + 1]);
      }
    return;
  }
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = pg * 32 + t * 16 + lane / 4 + 8 * i;
      if (r >= rows) continue;
      const float inv = 1.f / fmaxf(Ls[r], 1e-20f);
      float* o = out + (row0 + r) * kL + col0;
#pragma unroll
      for (int n = 0; n < kPvCols / 8; ++n)
        *reinterpret_cast<float2*>(o + n * 8) =
            make_float2(acc[t][n][2 * i] * inv, acc[t][n][2 * i + 1] * inv);
    }
}

cudaError_t configure() {
  static bool done = false;
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      mla_span_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  done = e == cudaSuccess;
  return e;
}

// (ceil(SH / kRows) x parts, B) CTAs of the tile
cudaError_t launch_tiles(const float* q_lat, const void* q_rope,
                         const void* c_pool, const void* kr_pool,
                         const LatentSpan& layout, float* out, void* ws,
                         int B, int parts, float scale, cudaStream_t stream) {
  cudaError_t e = configure();
  if (e != cudaSuccess) return e;
  const int tiles = (layout.SH + kRows - 1) / kRows;
  mla_span_kernel<<<dim3(tiles * parts, B), kThreads, kSmem, stream>>>(
      q_lat, static_cast<const bf16*>(q_rope),
      static_cast<const bf16*>(c_pool), static_cast<const bf16*>(kr_pool),
      out, static_cast<float*>(ws), layout, parts, scale);
  return cudaGetLastError();
}

// K4: the tiles, then mma_tile's combine pass where parts > 1 (workspace:
// tiles x parts x kRows x (512 + 2) floats)
cudaError_t launch(const float* q_lat, const void* q_rope,
                   const void* c_pool, const void* kr_pool,
                   const LatentSpan& layout, float* out, void* ws, int B,
                   int parts, float scale, cudaStream_t stream) {
  if (parts < 1 || parts > mma_tile::kMaxParts ||
      (parts > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  cudaError_t e = launch_tiles(q_lat, q_rope, c_pool, kr_pool, layout, out,
                               ws, B, parts, scale, stream);
  if (e != cudaSuccess || parts == 1) return e;
  const int tiles = (layout.SH + kRows - 1) / kRows;
  mma_tile::combine_kernel<kL, LatentSpan, float, mma_tile::bf16>
      <<<dim3(tiles * (kRows / mma_tile::kFoldRows), B), 128, 0, stream>>>(
          static_cast<const float*>(ws), nullptr, out, layout, parts);
  return cudaGetLastError();
}

constexpr int kDecodeMaxParts = 16;   // K3: key-range parts a row's tile

// Fold K3's parts: a CTA a (head, batch row), a float4 of the 512 output
// columns a thread, every part's (m, l) and acc loaded at once; a part
// with no key (m NEG_INF, l 0) gets weight 0.
__global__ void __launch_bounds__(kL / 4)
decode_combine_kernel(const float* __restrict__ ws, float* __restrict__ out,
                      int H, int parts) {
  const int r = blockIdx.x, b = blockIdx.y;
  const int ntiles = (H + kRows - 1) / kRows;
  const size_t tile = (size_t)b * ntiles + r / kRows;
  const size_t row = ws_rows(tile, parts, 0) + r % kRows;   // part 0's
  const size_t all = (size_t)ntiles * gridDim.y;
  const float* ml = ws + row * 2;
  const float* acc = ws + all * parts * kRows * 2 + row * kL
                     + 4 * threadIdx.x;
  float mv[kDecodeMaxParts], lv[kDecodeMaxParts];
  float4 f[kDecodeMaxParts];
#pragma unroll
  for (int p = 0; p < kDecodeMaxParts; ++p) {
    if (p < parts) {
      mv[p] = ml[(size_t)p * kRows * 2];
      lv[p] = ml[(size_t)p * kRows * 2 + 1];
      f[p] = *reinterpret_cast<const float4*>(acc + (size_t)p * kRows * kL);
    }
  }
  float M = kNegInf;
#pragma unroll
  for (int p = 0; p < kDecodeMaxParts; ++p)
    if (p < parts) M = fmaxf(M, mv[p]);
  float L = 0.f;
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int p = 0; p < kDecodeMaxParts; ++p) {
    if (p < parts) {
      const float w = exp2f(mv[p] - M);
      L += w * lv[p];
      o.x += w * f[p].x;
      o.y += w * f[p].y;
      o.z += w * f[p].z;
      o.w += w * f[p].w;
    }
  }
  const float inv = 1.f / fmaxf(L, 1e-20f);
  *reinterpret_cast<float4*>(out + ((size_t)b * H + r) * kL
                             + 4 * threadIdx.x) =
      make_float4(o.x * inv, o.y * inv, o.z * inv, o.w * inv);
}

// K3: a decode step is a span of one token (starts = seq_lens, SH = H):
// the tiles, then decode_combine_kernel where parts > 1 (workspace: B x
// ceil(H / kRows) x parts x kRows x (512 + 2) floats)
cudaError_t launch_decode(const float* q_lat, const void* q_rope,
                          const void* c_pool, const void* kr_pool,
                          const LatentSpan& layout, float* out, void* ws,
                          int B, int parts, float scale,
                          cudaStream_t stream) {
  if (parts < 1 || parts > kDecodeMaxParts || (parts > 1 && ws == nullptr)
      || B < 1 || B > 65535)
    return cudaErrorInvalidValue;
  cudaError_t e = launch_tiles(q_lat, q_rope, c_pool, kr_pool, layout, out,
                               ws, B, parts, scale, stream);
  if (e != cudaSuccess || parts == 1) return e;
  decode_combine_kernel<<<dim3(layout.H, B), kL / 4, 0, stream>>>(
      static_cast<const float*>(ws), out, layout.H, parts);
  return cudaGetLastError();
}

// whether the tile takes a launch's block size and latent widths
bool takes(int block_size, int lora, int rope) {
  return (block_size == 8 || block_size == 16 || block_size == 32) &&
         lora == kL && rope == kR;
}

cudaError_t resources(int* out) {
  cudaError_t e = configure();
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, mla_span_kernel);
  if (e != cudaSuccess) return e;
  int ctas = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, mla_span_kernel,
                                                    kThreads, kSmem);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)(kSmem + attr.sharedSizeBytes);
  out[3] = ctas;
  out[4] = kRows;
  return e;
}

}  // namespace mla_tile

constexpr size_t kSimtSmem = smem_floats<512, 64>() * sizeof(float);

// Lets the SIMT body use its dynamic shared memory (over the 48 KB
// default); once.
cudaError_t configure_simt() {
  static bool configured = false;
  if (configured) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      paged_mla_kernel<512, 64>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSimtSmem);
  configured = e == cudaSuccess;
  return e;
}

// the fp32 SIMT body over (ceil(SH / kRows), B) CTAs
int launch_simt(int lora, int rope, int block_size, const float* q_lat,
                const void* q_rope, const void* c_pool, const void* kr_pool,
                const int* tables, const int* starts, float* out, int B,
                int SH, int H, int mb, float scale, cudaStream_t stream) {
  if (!mla_tile::takes(block_size, lora, rope))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = configure_simt();
  if (e != cudaSuccess) return (int)e;
  dim3 grid((SH + kRows - 1) / kRows, B);
  paged_mla_kernel<512, 64><<<grid, kThreads, kSimtSmem, stream>>>(
      q_lat, static_cast<const float*>(q_rope),
      static_cast<const float*>(c_pool), static_cast<const float*>(kr_pool),
      tables, starts, out, SH, H, mb, block_size, scale);
  return (int)cudaGetLastError();
}

// out = {registers a thread, local (spill) bytes a thread, dynamic shared
// memory bytes a CTA, CTAs resident on one SM (as the runtime reports
// them), packed query rows a CTA} of the SIMT body
cudaError_t query_simt(int* out) {
  auto kern = paged_mla_kernel<512, 64>;
  cudaError_t e = configure_simt();
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kern);
  if (e != cudaSuccess) return e;
  int ctas = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kern, kThreads,
                                                    kSimtSmem);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)kSimtSmem;
  out[3] = ctas;
  out[4] = kRows;
  return e;
}

}  // namespace

extern "C" {

// K3.  q_lat (B, H, lora) float32; q_rope (B, H, rope); pools c (nb, bs,
// lora), kr (nb, bs, rope); tables (B, mb) int32; seq_lens (B,) int32 (the
// query's position); out (B, H, lora) float32.
// dtype of q_rope and the pools: 0 = float32 (the SIMT body, parts = 1),
// 1 = bfloat16 (the tensor-core tile: each row's keys split into `parts`
// (1..16) CTAs, workspace (fp32, parts > 1) of B x ceil(H / 64) x parts x
// 64 x (lora + 2) floats).
int paged_decode_mla(int dtype, int lora, int rope, int block_size,
                     const float* q_lat, const void* q_rope,
                     const void* c_pool, const void* kr_pool,
                     const int* tables, const int* seq_lens, float* out,
                     int B, int H, int mb, float scale, int parts,
                     void* workspace, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (!mla_tile::takes(block_size, lora, rope))
      return (int)cudaErrorInvalidValue;
    const mla_tile::LatentSpan layout{tables, seq_lens, H, H, mb, block_size};
    return (int)mla_tile::launch_decode(q_lat, q_rope, c_pool, kr_pool,
                                        layout, out, workspace, B, parts,
                                        scale, s);
  }
  if (dtype != 0 || parts != 1) return (int)cudaErrorInvalidValue;
  return launch_simt(lora, rope, block_size, q_lat, q_rope, c_pool, kr_pool,
                     tables, seq_lens, out, B, H, H, mb, scale, s);
}

// K4.  q_lat (B, S*H, lora) packed rows i*H + h; q_rope (B, S*H, rope);
// starts (B,) int32 (position of span token 0); out (B, S*H, lora) float32.
// bf16 runs the tensor-core tile: each row tile's keys split into `parts`
// (1..4) CTAs, workspace (fp32, parts > 1) of tiles x parts x 64 x
// (lora + 2) floats, tiles = ceil(S*H / 64) * B; fp32 takes parts = 1.
int paged_prefill_mla(int dtype, int lora, int rope, int block_size,
                      const float* q_lat, const void* q_rope,
                      const void* c_pool, const void* kr_pool,
                      const int* tables, const int* starts, float* out,
                      int B, int SH, int H, int mb, float scale, int parts,
                      void* workspace, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (!mla_tile::takes(block_size, lora, rope))
      return (int)cudaErrorInvalidValue;
    const mla_tile::LatentSpan layout{tables, starts, SH, H, mb, block_size};
    return (int)mla_tile::launch(q_lat, q_rope, c_pool, kr_pool, layout, out,
                                 workspace, B, parts, scale, s);
  }
  if (dtype != 0 || parts != 1) return (int)cudaErrorInvalidValue;
  return launch_simt(lora, rope, block_size, q_lat, q_rope, c_pool, kr_pool,
                     tables, starts, out, B, SH, H, mb, scale, s);
}

// Resources of K3's and K4's body for `dtype` (launches nothing): 0 the
// fp32 SIMT body, 1 the bf16 tensor-core tile.  out[5] = registers a
// thread, spill bytes a thread, shared memory bytes a CTA, CTAs resident on
// one SM, packed query rows a CTA.
int paged_mla_resources(int dtype, int lora, int rope, int* out) {
  if (lora != mla_tile::kL || rope != mla_tile::kR)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)query_simt(out);
  if (dtype == 1) return (int)mla_tile::resources(out);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
