// Paged GQA attention for Hopper (sm_90a): K1 flash-decode and K2 span
// prefill, both reading K/V blocks IN PLACE through the block table.
//
// Replaces the TPU kernels of the JAX package:
//   K1  src/repro/kernels/paged_attention/kernel.py   paged_decode_gqa
//   K2  src/repro/kernels/paged_attention/prefill.py  paged_prefill_gqa
//
// Contract (the same as the Pallas kernels): token position p of row b lives
// at (tables[b, p / BS], p % BS); packed query row r of (b, kv-head) is group
// query g = r % G of span token i = r / G at absolute position starts[b] + i
// (decode: S = 1 and starts = seq_lens).  A query attends every position
// k_pos <= q_pos, and with a window only q_pos - k_pos < window.  Scores are
// scaled by d^-1/2, soft-capped c*tanh(s/c) before masking, and folded with
// an fp32 online softmax; a row that sees no key gets 0 (the final division
// clamps l at 1e-20).
//
// What bounds it on this card: decode reads (seq_len + 1) * KVH * d * 2
// values per row and does 4 flops per value and group query, far below the
// ~295 flop/byte ridge of an H100 in bf16: the live K/V bytes bound it.
// Span prefill at S*G rows per kv-head does S*G times more work per byte
// and, at the chunk sizes the engine uses, is bound by its arithmetic.
//
// What the design does about it:
//   * decode (K1, both dtypes) is split-KV (namespace decode_split below):
//     a CTA of 4 warps takes up to 8 query rows of one (kv-head, batch row)
//     and one of `parts` runs of whole pool blocks of that row's live range,
//     cut on the device from seq_lens, so B * KVH * parts CTAs fill the card
//     (the wrapper picks parts from the shapes alone, one wave of the CTA
//     slots the occupancy query reports; seq_lens never goes to the host).
//     A run's block ids are read into shared memory once; q stays in
//     registers; K and V are read as 16-byte vectors in the pool's own dtype
//     straight into registers, never staged in shared memory.  Each warp
//     folds its keys with its own fp32 online softmax; the warps fold
//     through shared memory, and with parts > 1 a combine kernel folds the
//     parts' (m, l, acc) from a workspace.  At G = 8 the products are not
//     free on the CUDA cores: a lane-per-dims SIMT body spends ~150
//     instructions a key (FMAs, the shuffles that sum a score over the
//     lanes of a key, the exps), and its rounds measured ~3.5 us each on
//     the card.  So the bf16 body (mma_kernel), the serving path, runs
//     QK^T and PV on mma.sync with the 8 query rows as the N of the
//     product (S^T = K Q^T, O^T = V^T P^T: no row is padding), K and V
//     taken as fragments straight from their 16-byte loads under a
//     permuted k index, P and V transposed into place by movmatrix; P is
//     rounded to bf16 for PV, as mma_tile.cuh does, and l sums the fp32 p.
//     The fp32 body (simt_kernel, the exact parity route) keeps FMAs on
//     the CUDA cores;
//   * span prefill: one CTA per (query-row tile, kv-head, batch row) walks
//     only that tile's live blocks itself: it loads its own table entries
//     and start, begins at the first in-window block and stops at the block
//     of its last query position (causal early exit per tile), so traffic is
//     O(live tokens) and nothing is gathered into a padded view.  The Pallas
//     prefill kernel keeps the whole packed span resident (4 MB of fp32
//     accumulator at S = 1024, G = 8, d = 128); here the query rows are
//     tiled and the accumulator lives in registers.  bf16 span prefill, the
//     serving path, runs mma_tile.cuh's tensor-core tile (mma.sync QK^T and
//     PV, K/V kept bf16 in a cp.async ring, the tile's causal key range split
//     over up to 4 CTAs and folded by a combine pass so the 128 tiles of a
//     serve span fill the card): PagedSpan below is its layout.  fp32 span
//     prefill (the exact parity runs) runs gqa_tile.cuh's SIMT body (K/V
//     staged as fp32, scalar FMAs): PagedKV below is its layout.
// Not done yet (later work): wgmma and TMA for the span tile.
//
// Head dims: 64, 80 (zamba2's shared attention block), 96 (phi-3-vision),
// 128 and 256; block sizes 8, 16 and 32.  At d 80 the bf16 decode body adds
// a half chunk of 16 dims to its 32-dim chunks (one k-step, one m-tile),
// the fp32 decode body gives a key a whole warp (20 of 32 lanes live), and
// the fp32 span tile leaves 48 of 128 threads out of P V; zamba2 is MHA
// (G 1), so the decode CTA's 8 query rows hold 1 (the tile was built for
// GQA groups).  d 96 is three whole 32-dim chunks in the bf16 decode body
// (six k-steps, six m-tiles), 24 of 32 lanes a key in the fp32 one, and 96
// of 128 threads in the fp32 span tile's P V; phi-3 is MHA too.  A group
// of G query heads takes ceil(G / 8) decode CTAs a KV head (G 3 and 6
// leave rows of the one idle, G 16 fills two); the span tiles take the
// packed rows i*G + g as they come, 64 a tile, whatever G cuts them at.
//
// Interface: plain C, loaded with ctypes.  Each entry point returns the
// cudaError_t of its launch (0 on success); it launches on the given stream,
// does not synchronise and allocates nothing.

#include <cuda_runtime.h>
#include <stddef.h>

#include "gqa_tile.cuh"
#include "mma_tile.cuh"

namespace {

// ---------------------------------------------------------------------------
// K1: split-KV decode
// ---------------------------------------------------------------------------
namespace decode_split {

using mma_tile::bf16;
using mma_tile::log2_score;
using mma_tile::mma16816;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 8;          // group queries a CTA (G > 8: more tiles)
constexpr int kMaxParts = 16;     // runs of blocks a row's live range takes
constexpr int kTable = 64;        // a run's block ids kept in shared memory

// The run of a CTA: run `part` of `parts` of batch row b's live range
// [lo, hi] (lo the window's first position, hi the query's, at most the
// table's last: every key in it is visible), its blocks cut into runs of
// ceil(blocks / parts); keys first .. last (empty when last < first).
template <int BS>
struct Run {
  int first, last, b_first;
  __device__ Run(int qpos, int mb, int window, int part, int parts) {
    const int lo = window > 0 ? max(qpos - window + 1, 0) : 0;
    const int hi = min(qpos, mb * BS - 1);
    const int blo = lo / BS;
    const int nblk = hi >= lo ? hi / BS - blo + 1 : 0;
    const int per = (nblk + parts - 1) / parts;
    first = max(lo, (blo + part * per) * BS);
    last = min(hi, (blo + (part + 1) * per) * BS - 1);
    b_first = first / BS;
  }
};

// The CTA's state in shared memory: each warp's (m, l, acc) of every row,
// the fold's weights, and the run's first kTable block ids (read once, so a
// round's K/V addresses wait on no global load).
template <int D>
struct Shared {
  float m[kWarps][kRows], l[kWarps][kRows];
  float w[kWarps][kRows], sum[kRows];
  __align__(16) float acc[kWarps][kRows][D];
  int blk[kTable];
};

template <int BS>
__device__ inline void load_table(int* blk, const int* trow,
                                  const Run<BS>& run) {
  const int n = run.last >= run.first ? run.last / BS - run.b_first + 1 : 0;
  for (int i = threadIdx.x; i < min(n, kTable); i += kThreads)
    blk[i] = __ldg(trow + run.b_first + i);
}

// K/V row (in units of D) of position pos of the run
template <int BS>
__device__ inline size_t kv_row(const int* blk, const int* trow,
                                const Run<BS>& run, int pos, int KVH,
                                int kvh) {
  const int bi = pos / BS - run.b_first;
  const int id = bi < kTable ? blk[bi] : __ldg(trow + pos / BS);
  return ((size_t)id * BS + pos % BS) * KVH + kvh;
}

// After every warp's (m, l, acc) is in shared memory: fold the warps and
// write out (parts == 1) or this run's (m, l, acc) to the workspace.
template <typename T, int D>
__device__ inline void fold_warps(Shared<D>& sm, T* __restrict__ out,
                                  float* __restrict__ ws, size_t qrow0,
                                  int rows) {
  const int parts = gridDim.x, part = blockIdx.x, tid = threadIdx.x;
  __syncthreads();
  const size_t ntiles = (size_t)gridDim.y * gridDim.z;
  const size_t tile = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  if (tid < kRows) {
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm.m[w][tid]);
    float Ls = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      sm.w[w][tid] = exp2f(sm.m[w][tid] - M);
      Ls += sm.w[w][tid] * sm.l[w][tid];
    }
    sm.sum[tid] = Ls;
    if (parts > 1 && tid < rows) {
      float* ml = ws + ((tile * parts + part) * kRows + tid) * 2;
      ml[0] = M;
      ml[1] = Ls;
    }
  }
  __syncthreads();
  float* wacc = ws + ntiles * parts * kRows * 2
                + (tile * parts + part) * kRows * D;
  for (int i = tid; i < rows * D; i += kThreads) {
    const int r = i / D, c = i % D;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += sm.w[w][r] * sm.acc[w][r][c];
    if (parts > 1)
      wacc[(size_t)r * D + c] = a;
    else
      store_out(out + (qrow0 + r) * D + c, a / fmaxf(sm.sum[r], 1e-20f));
  }
}

// ---- the fp32 body: SIMT ----------------------------------------------------

// How a warp reads a key row of D fp32 elements: a 16-byte vector holds 4,
// kPerKey lanes share a key (kLoads vectors each, kDims dims a lane), so one
// load instruction of the warp covers kSlots keys; a lane keeps kUnroll keys
// (of its slot) in flight, K and V, 8 vectors.  kPerKey is the row's
// vectors rounded up to a power of two (the shuffle sums of a score are
// butterflies), at most 32: at d 80 a key's 20 vectors take a warp, and
// lanes 20-31 hold zeros (live() false), load nothing and store nothing.
constexpr int pow2_ceil(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

template <int D>
struct Lanes {
  static constexpr int kVec = 4;
  static constexpr int kVecs = D / kVec;             // vectors a key row
  static constexpr int kPerKey = pow2_ceil(kVecs) < 32 ? pow2_ceil(kVecs)
                                                       : 32;
  static constexpr int kLoads = (kVecs + kPerKey - 1) / kPerKey;
  static constexpr int kDims = kLoads * kVec;
  static constexpr int kSlots = 32 / kPerKey;
  static constexpr int kUnroll = 4 / kLoads;
  static constexpr int kKeys = kSlots * kUnroll;   // keys a warp a round
  static_assert(D % kVec == 0 && kUnroll >= 1, "lane split");
  // element of vector l of lane li of a key row
  __device__ static int elem(int l, int li) {
    return (l * kPerKey + li) * kVec;
  }
  // whether vector l of lane li lies in the row
  __device__ static bool live(int l, int li) {
    return kVecs % kPerKey == 0 || l * kPerKey + li < kVecs;
  }
};

// One CTA: the rows r0 .. r0 + rows - 1 of (batch row z, kv head y / rt),
// the keys of run x.  A lane owns kDims dims of kSlots' keys: scores are
// summed over the slot's lanes by shuffles, P V accumulates in registers.
template <int D, int BS>
__global__ void __launch_bounds__(kThreads)
simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const int* __restrict__ tables,
            const int* __restrict__ seq_lens, float* __restrict__ out,
            float* __restrict__ ws, int KVH, int G, int mb, int window,
            float softcap, float scale) {
  using L = Lanes<D>;
  constexpr int VN = L::kVec, ND = L::kDims, NU = L::kUnroll;
  __shared__ Shared<D> sm;
  const int rt = (G + kRows - 1) / kRows;
  const int kvh = blockIdx.y / rt, r0 = (blockIdx.y % rt) * kRows;
  const int b = blockIdx.z;
  const int rows = min(kRows, G - r0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int slot = lane / L::kPerKey, li = lane % L::kPerKey;
  const Run<BS> run(seq_lens[b], mb, window, blockIdx.x, gridDim.x);
  const int* trow = tables + (size_t)b * mb;
  load_table(sm.blk, trow, run);

  const size_t qrow0 = ((size_t)b * KVH + kvh) * G + r0;
  float qf[kRows][ND];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int l = 0; l < L::kLoads; ++l) {
      if (r < rows && L::live(l, li)) {
        Vec<float>::convert(ld16(q + (qrow0 + r) * D + L::elem(l, li)),
                            &qf[r][l * VN]);
      } else {
#pragma unroll
        for (int e = 0; e < VN; ++e) qf[r][l * VN + e] = 0.f;
      }
    }
  float m[kRows], lsum[kRows], acc[kRows][ND];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    lsum[r] = 0.f;
#pragma unroll
    for (int e = 0; e < ND; ++e) acc[r][e] = 0.f;
  }
  __syncthreads();   // the block ids

  for (int base = run.first + warp * L::kKeys; base <= run.last;
       base += kWarps * L::kKeys) {
    // every load of the round issued before any is used
    uint4 kr[NU][L::kLoads], vr[NU][L::kLoads];
    bool ok[NU];
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const int pos = base + u * L::kSlots + slot;
      ok[u] = pos <= run.last;
      if (ok[u]) {
        const size_t row = kv_row(sm.blk, trow, run, pos, KVH, kvh);
#pragma unroll
        for (int l = 0; l < L::kLoads; ++l) {
          if (L::live(l, li)) {
            kr[u][l] = ld16(k + row * D + L::elem(l, li));
            vr[u][l] = ld16(v + row * D + L::elem(l, li));
          } else {
            kr[u][l] = vr[u][l] = make_uint4(0u, 0u, 0u, 0u);
          }
        }
      } else {
#pragma unroll
        for (int l = 0; l < L::kLoads; ++l)
          kr[u][l] = vr[u][l] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    // scores of the slot's keys against every row, summed over the slot's
    // lanes, in log2 units; -inf past the run
    float s[NU][kRows];
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      float kf[ND];
#pragma unroll
      for (int l = 0; l < L::kLoads; ++l)
        Vec<float>::convert(kr[u][l], &kf[l * VN]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < ND; ++e) dot = fmaf(qf[r][e], kf[e], dot);
#pragma unroll
        for (int o = L::kPerKey / 2; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        s[u][r] = ok[u] ? log2_score(dot, scale, softcap) : -INFINITY;
      }
    }
    // the online softmax of the slot (masked keys: p = 0)
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float mx = s[0][r];
#pragma unroll
      for (int u = 1; u < NU; ++u) mx = fmaxf(mx, s[u][r]);
      const float m_new = fmaxf(m[r], mx);
      const float alpha = exp2f(m[r] - m_new);
      m[r] = m_new;
      lsum[r] *= alpha;
#pragma unroll
      for (int e = 0; e < ND; ++e) acc[r][e] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      float vf[ND];
#pragma unroll
      for (int l = 0; l < L::kLoads; ++l)
        Vec<float>::convert(vr[u][l], &vf[l * VN]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float p = exp2f(s[u][r] - m[r]);
        lsum[r] += p;
#pragma unroll
        for (int e = 0; e < ND; ++e) acc[r][e] = fmaf(p, vf[e], acc[r][e]);
      }
    }
  }

  // fold the warp's slots (lanes kPerKey apart hold the same dims)
#pragma unroll
  for (int o = L::kPerKey; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], o);
      const float lo = __shfl_xor_sync(0xffffffffu, lsum[r], o);
      const float mn = fmaxf(m[r], mo);
      const float a = exp2f(m[r] - mn), c = exp2f(mo - mn);
      m[r] = mn;
      lsum[r] = lsum[r] * a + lo * c;
#pragma unroll
      for (int e = 0; e < ND; ++e)
        acc[r][e] = acc[r][e] * a
                    + __shfl_xor_sync(0xffffffffu, acc[r][e], o) * c;
    }
  }
  if (slot == 0) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int l = 0; l < L::kLoads; ++l) {
        if (!L::live(l, li)) continue;
        float* dst = &sm.acc[warp][r][L::elem(l, li)];
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[r][l * VN], acc[r][l * VN + 1],
                        acc[r][l * VN + 2], acc[r][l * VN + 3]);
      }
      if (li == 0) {
        sm.m[warp][r] = m[r];
        sm.l[warp][r] = lsum[r];
      }
    }
  }
  fold_warps(sm, out, ws, qrow0, rows);
}

// ---- the bf16 body: tensor cores --------------------------------------------

// 8 x 8 bf16 transpose across the warp: lane (g, t) holds [g][2t, 2t + 1]
// of a matrix in, [g][2t, 2t + 1] of its transpose out
__device__ inline uint32_t trans8x8(uint32_t x) {
  uint32_t r;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(r) : "r"(x));
  return r;
}

__device__ inline uint2 ld8(const void* p) {
  return *reinterpret_cast<const uint2*>(p);
}

// 16-key groups a warp keeps in flight: K and V of 32 keys, 16 KB a warp
// at d 128 (one group measured the same at the serve shape); d 256 takes
// one, for its registers
template <int D>
constexpr int kGroups = D <= 128 ? 2 : 1;

// One CTA, as simt_kernel's, on mma.sync m16n8k16 (bf16 in, fp32
// accumulate).  A warp takes 16 keys a group: S^T = K Q^T with K (16 keys x
// 16 dims) the A operand straight from its 16-byte loads and the 8 query
// rows the N of the product (q in registers as B fragments), so no row is
// padding.  The k index is permuted within each 32 dims: lane t's 16 bytes
// (dims 8t .. 8t + 7) are its k slots 2t, 2t + 1, 2t + 8, 2t + 9 of two
// k-steps, in K and q alike.  Lane (g, t) then holds the scores of keys g
// and g + 8 for rows 2t and 2t + 1: a row's max is 3 shuffles over g.
// O^T = V^T P^T: P^T (bf16, the scores' own layout) and V (each lane's
// 16-byte loads) become the B and A fragments by movmatrix transposes,
// which also permutes the output dims: m-tile (c, j) row g of O^T is dim
// 32c + 8 (g / 2) + 2 (2j + h) + g % 2, h = 0 for rows g, 1 for g + 8.
// Where D is an odd multiple of 16 (d 80), its last 16 dims are a half
// chunk: lane t's 8 bytes (dims 4t .. 4t + 3 of it) are its k slots 2t,
// 2t + 1, 2t + 8, 2t + 9 of one k-step, and one more m-tile of O^T, whose
// row g is dim 32 NC + 4 (g / 2) + 2 h + g % 2.
template <int D, int BS>
__global__ void __launch_bounds__(kThreads)
mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const int* __restrict__ tables,
           const int* __restrict__ seq_lens, bf16* __restrict__ out,
           float* __restrict__ ws, int KVH, int G, int mb, int window,
           float softcap, float scale) {
  constexpr int NC = D / 32;            // 32-dim chunks: 16 bytes a lane
  constexpr bool HALF = D % 32 == 16;   // a last 16-dim chunk: 8 bytes
  constexpr int NT = 2 * NC + HALF;     // O^T m-tiles
  static_assert(D % 16 == 0, "head dim");
  constexpr int NG = kGroups<D>;
  __shared__ Shared<D> sm;
  const int rt = (G + kRows - 1) / kRows;
  const int kvh = blockIdx.y / rt, r0 = (blockIdx.y % rt) * kRows;
  const int b = blockIdx.z;
  const int rows = min(kRows, G - r0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const Run<BS> run(seq_lens[b], mb, window, blockIdx.x, gridDim.x);
  const int* trow = tables + (size_t)b * mb;
  load_table(sm.blk, trow, run);

  // q row g's chunks: the B fragments of S^T = K Q^T (zero past G)
  const size_t qrow0 = ((size_t)b * KVH + kvh) * G + r0;
  uint4 qb[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c)
    qb[c] = g < rows ? ld16(q + (qrow0 + g) * D + 32 * c + 8 * t)
                     : make_uint4(0u, 0u, 0u, 0u);
  uint2 qh = make_uint2(0u, 0u);        // the half chunk's
  if (HALF && g < rows) qh = ld8(q + (qrow0 + g) * D + 32 * NC + 4 * t);
  // rows 2t, 2t + 1: running max (log2 units), this lane's share of l
  float m[2] = {kNegInf, kNegInf}, lsum[2] = {0.f, 0.f};
  float acc[NT][4];                     // O^T m-tiles (c, j), the half's
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  __syncthreads();   // the block ids

  for (int base = run.first + warp * 16 * NG; base <= run.last;
       base += kWarps * 16 * NG) {
    // K and V of keys base + 16 n + g + 8 h, every load before any use
    uint4 kr[NG][2][NC], vr[NG][2][NC];
    uint2 kh[NG][2], vh[NG][2];
    bool ok[NG][2];
#pragma unroll
    for (int n = 0; n < NG; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pos = base + 16 * n + 8 * h + g;
        ok[n][h] = pos <= run.last;
        if (ok[n][h]) {
          const size_t row = kv_row(sm.blk, trow, run, pos, KVH, kvh);
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            kr[n][h][c] = ld16(k + row * D + 32 * c + 8 * t);
            vr[n][h][c] = ld16(v + row * D + 32 * c + 8 * t);
          }
          if constexpr (HALF) {
            kh[n][h] = ld8(k + row * D + 32 * NC + 4 * t);
            vh[n][h] = ld8(v + row * D + 32 * NC + 4 * t);
          }
        } else {
#pragma unroll
          for (int c = 0; c < NC; ++c)
            kr[n][h][c] = vr[n][h][c] = make_uint4(0u, 0u, 0u, 0u);
          kh[n][h] = vh[n][h] = make_uint2(0u, 0u);
        }
      }
#pragma unroll
    for (int n = 0; n < NG; ++n) {
      // S^T (16 keys x 8 rows): two k-steps a chunk (halves of the 16
      // bytes: words x, y then z, w)
      float st[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const uint4 k0 = kr[n][0][c], k1 = kr[n][1][c], qc = qb[c];
        const uint32_t a_lo[4] = {k0.x, k1.x, k0.y, k1.y};
        const uint32_t a_hi[4] = {k0.z, k1.z, k0.w, k1.w};
        mma16816(st, a_lo, qc.x, qc.y);
        mma16816(st, a_hi, qc.z, qc.w);
      }
      if constexpr (HALF) {
        const uint2 k0 = kh[n][0], k1 = kh[n][1];
        const uint32_t a[4] = {k0.x, k1.x, k0.y, k1.y};
        mma16816(st, a, qh.x, qh.y);
      }
      // st[0..1]: key g, rows 2t, 2t + 1; st[2..3]: key g + 8
      float mx[2];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        st[e] = ok[n][e / 2] ? log2_score(st[e], scale, softcap) : -INFINITY;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(st[i], st[i + 2]);
#pragma unroll
        for (int o = 4; o < 32; o <<= 1)
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], o));
        const float m_new = fmaxf(m[i], mx[i]);
        const float alpha = exp2f(m[i] - m_new);
        m[i] = m_new;
        lsum[i] *= alpha;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          acc[j][i] *= alpha;        // column 2t + i of O^T: row 2t + i
          acc[j][i + 2] *= alpha;
        }
      }
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(st[e] - m[e % 2]);      // masked: exp2(-inf) = 0
        lsum[e % 2] += p[e];
      }
      // P^T's B fragments: keys 2t, 2t + 1 (and + 8) of row g
      const uint32_t pb0 = trans8x8(mma_tile::pack_bf16(p[0], p[1]));
      const uint32_t pb1 = trans8x8(mma_tile::pack_bf16(p[2], p[3]));
      // O^T += V^T P^T, m-tile (c, j): V words 2j (rows g) and 2j + 1
      // (rows g + 8) of keys g (k 0-7) and g + 8 (k 8-15), transposed
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const uint4 v0 = vr[n][0][c], v1 = vr[n][1][c];
        const uint32_t a0[4] = {trans8x8(v0.x), trans8x8(v0.y),
                                trans8x8(v1.x), trans8x8(v1.y)};
        const uint32_t a1[4] = {trans8x8(v0.z), trans8x8(v0.w),
                                trans8x8(v1.z), trans8x8(v1.w)};
        mma16816(acc[2 * c], a0, pb0, pb1);
        mma16816(acc[2 * c + 1], a1, pb0, pb1);
      }
      if constexpr (HALF) {
        const uint2 v0 = vh[n][0], v1 = vh[n][1];
        const uint32_t a[4] = {trans8x8(v0.x), trans8x8(v0.y),
                               trans8x8(v1.x), trans8x8(v1.y)};
        mma16816(acc[2 * NC], a, pb0, pb1);
      }
    }
  }

  // l over the lanes of a row (m is already uniform over them), then the
  // warp's rows 2t, 2t + 1 to shared memory in their dims' order
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int o = 4; o < 32; o <<= 1)
      lsum[i] += __shfl_xor_sync(0xffffffffu, lsum[i], o);
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int dim = 32 * c + 8 * (g / 2) + 2 * (2 * j + e / 2) + g % 2;
        sm.acc[warp][2 * t + e % 2][dim] = acc[2 * c + j][e];
      }
  if constexpr (HALF) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int dim = 32 * NC + 4 * (g / 2) + 2 * (e / 2) + g % 2;
      sm.acc[warp][2 * t + e % 2][dim] = acc[2 * NC][e];
    }
  }
  if (g == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sm.m[warp][2 * t + i] = m[i];
      sm.l[warp][2 * t + i] = lsum[i];
    }
  }
  fold_warps(sm, out, ws, qrow0, rows);
}

// Fold the parts of a split launch: a CTA a query row (D / 4 threads, a
// float4 of the output each), every part's loads issued at once.
template <typename T, int D>
__global__ void __launch_bounds__(D / 4)
combine_kernel(const float* __restrict__ ws, T* __restrict__ out, int KVH,
               int G, int parts) {
  const int rt = (G + kRows - 1) / kRows;
  const int y = blockIdx.x / kRows, r = blockIdx.x % kRows;
  const int kvh = y / rt, r0 = (y % rt) * kRows;
  if (r0 + r >= G) return;
  const int b = blockIdx.y;
  const size_t ny = (size_t)KVH * rt;
  const size_t tile = (size_t)b * ny + y;
  const float* ml = ws + (tile * parts * kRows + r) * 2;
  const float* acc = ws + ny * gridDim.y * parts * kRows * 2
                     + (tile * parts * kRows + r) * D + 4 * threadIdx.x;
  float mv[kMaxParts], lv[kMaxParts];
  float4 f[kMaxParts];
#pragma unroll
  for (int p = 0; p < kMaxParts; ++p) {
    if (p < parts) {
      mv[p] = ml[(size_t)p * kRows * 2];
      lv[p] = ml[(size_t)p * kRows * 2 + 1];
      f[p] = *reinterpret_cast<const float4*>(acc + (size_t)p * kRows * D);
    }
  }
  float M = kNegInf;
#pragma unroll
  for (int p = 0; p < kMaxParts; ++p)
    if (p < parts) M = fmaxf(M, mv[p]);
  float Ls = 0.f, o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int p = 0; p < kMaxParts; ++p) {
    if (p < parts) {
      const float w = exp2f(mv[p] - M);
      Ls += w * lv[p];
      o[0] += w * f[p].x;
      o[1] += w * f[p].y;
      o[2] += w * f[p].z;
      o[3] += w * f[p].w;
    }
  }
  const float inv = 1.f / fmaxf(Ls, 1e-20f);
  T* dst = out + (((size_t)b * KVH + kvh) * G + r0 + r) * D
           + 4 * threadIdx.x;
#pragma unroll
  for (int u = 0; u < 4; ++u) store_out(dst + u, o[u] * inv);
}

// the body of dtype T: SIMT for fp32, tensor cores for bf16
template <typename T, int D, int BS>
auto body() {
  if constexpr (sizeof(T) == 4)
    return simt_kernel<D, BS>;
  else
    return mma_kernel<D, BS>;
}

// Launch K1 over (parts, KVH * ceil(G / kRows), B) CTAs, then the combine
// pass where parts > 1 (workspace: B * KVH * ceil(G / kRows) * parts *
// kRows * (D + 2) floats).
template <typename T, int D, int BS>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* tables, const int* seq_lens, void* out,
                   void* ws, int B, int KVH, int G, int mb, int window,
                   float softcap, float scale, int parts,
                   cudaStream_t stream) {
  if (parts < 1 || parts > kMaxParts || (parts > 1 && ws == nullptr) ||
      B < 1 || B > 65535 || G < 1)
    return cudaErrorInvalidValue;
  const int rt = (G + kRows - 1) / kRows;
  const dim3 grid(parts, KVH * rt, B);
  const auto kern = body<T, D, BS>();
  kern<<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), tables, seq_lens, static_cast<T*>(out),
      static_cast<float*>(ws), KVH, G, mb, window, softcap, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || parts == 1) return e;
  combine_kernel<T, D><<<dim3(KVH * rt * kRows, B), D / 4, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<T*>(out), KVH, G, parts);
  return cudaGetLastError();
}

// out = {registers a thread, local (spill) bytes a thread, shared memory
// bytes a CTA, CTAs resident on one SM, query rows a CTA} of the body
template <typename T, int D, int BS>
cudaError_t resources(int* out) {
  auto kern = body<T, D, BS>();
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kern);
  if (e != cudaSuccess) return e;
  int ctas = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kern, kThreads, 0);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)attr.sharedSizeBytes;
  out[3] = ctas;
  out[4] = kRows;
  return e;
}

}  // namespace decode_split

// ---------------------------------------------------------------------------
// K2: span prefill
// ---------------------------------------------------------------------------

// K1/K2's layout: packed query rows (b, kv head, r) are contiguous; token
// position p of row b lives at (tables[b, p / BS], p % BS) of the pools;
// every span is causal by absolute position, and a tile reads from the
// first block in its window to the block of its last query.
template <int BS>
struct PagedKV {
  const int* tables;
  const int* starts;
  int KVH, SG, mb;
  __device__ int start(int b) const { return starts[b]; }
  __device__ bool causal() const { return true; }
  __device__ size_t q_row(int b, int kvh, int r) const {
    return ((size_t)b * KVH + kvh) * SG + r;
  }
  __device__ size_t kv_row(int b, int kvh, int pos) const {
    return ((size_t)tables[(size_t)b * mb + pos / BS] * BS + pos % BS) * KVH
           + kvh;
  }
  __device__ void range(int q_first, int q_last, int window, int& lo,
                        int& hi) const {
    lo = window > 0 ? max(q_first - window + 1, 0) : 0;
    lo = (lo / BS) * BS;
    hi = min(q_last, mb * BS - 1);
  }
};

// K2's layout on the tensor-core tile (grid y = kv head, z = batch row):
// the same rows and keys as PagedKV, flat key index = position.
template <int BS>
struct PagedSpan {
  static constexpr int kList = 1;        // no shared list
  static constexpr bool kMean = false;   // a row with no key gets 0
  const int* tables;
  const int* starts;
  int KVH, SG, G, mb, window;
  __device__ bool causal() const { return true; }
  __device__ int rows(int, int) const { return SG; }
  __device__ int pos0(int, int z) const { return starts[z]; }
  __device__ size_t q_row(int y, int z, int r) const {
    return ((size_t)z * KVH + y) * SG + r;
  }
  __device__ size_t out_row(int y, int z, int r) const {
    return q_row(y, z, r);
  }
  __device__ void list_keys(int, int, int q_first, int q_last, int*,
                            int* range) const {
    const int lo = window > 0 ? max(q_first - window + 1, 0) : 0;
    range[0] = (lo / BS) * BS;
    range[1] = min(q_last, mb * BS - 1);
  }
  __device__ int key(int y, int z, int t, const int*, size_t& row) const {
    row = ((size_t)__ldg(tables + (size_t)z * mb + t / BS) * BS + t % BS)
          * KVH + y;
    return t;
  }
};

struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const int* tables;
  const int* starts;
  void* out;
  int B, KVH, SG, G, mb, window;
  float softcap, scale;
  int parts;
  void* ws;
};

// the SIMT body: fp32 span prefill (64 rows a CTA at d <= 128, 32 at d =
// 256: the register budget of the per-thread accumulator, the shared memory
// of the fp32 tiles)
template <int D, int BS>
cudaError_t launch_simt(const Args& a, cudaStream_t stream) {
  constexpr int kRowsPrefill = D <= 128 ? 64 : 32;
  const PagedKV<BS> layout{a.tables, a.starts, a.KVH, a.SG, a.mb};
  return launch_gqa_tiles<D, kRowsPrefill>(
      a.q, a.k_pool, a.v_pool, a.out, layout, a.B, a.KVH, a.SG, a.G,
      a.window, a.softcap, a.scale, stream);
}

// the tensor-core body: bf16 span prefill
template <int D, int BS>
cudaError_t launch_mma(const Args& a, cudaStream_t stream) {
  const PagedSpan<BS> layout{a.tables, a.starts, a.KVH, a.SG, a.G, a.mb,
                             a.window};
  return mma_tile::launch_attention<D, D>(a.q, a.k_pool, a.v_pool, a.out,
                                          a.ws, layout, a.SG, a.KVH, a.B,
                                          a.parts, a.softcap, a.scale,
                                          stream);
}

// the split-KV decode body, both dtypes
template <typename T, int D, int BS>
cudaError_t launch_decode(const Args& a, cudaStream_t stream) {
  return decode_split::launch<T, D, BS>(
      a.q, a.k_pool, a.v_pool, a.tables, a.starts, a.out, a.ws, a.B, a.KVH,
      a.G, a.mb, a.window, a.softcap, a.scale, a.parts, stream);
}

// what an entry point does at (dtype, D, BS): launch K1 or K2, or query
// K1's or K2's resources (into out)
enum class Op { kDecode, kPrefill, kDecodeQuery, kPrefillQuery };

template <int D, int BS>
cudaError_t at_block(Op op, int dtype, const Args& a, int* out,
                     cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  switch (op) {
    case Op::kDecode:
      return dtype == 0 ? launch_decode<float, D, BS>(a, s)
                        : launch_decode<bf16, D, BS>(a, s);
    case Op::kPrefill:
      return dtype == 0 ? launch_simt<D, BS>(a, s) : launch_mma<D, BS>(a, s);
    case Op::kDecodeQuery:
      return dtype == 0 ? decode_split::resources<float, D, BS>(out)
                        : decode_split::resources<bf16, D, BS>(out);
    case Op::kPrefillQuery:
      return mma_tile::resources<D, D, PagedSpan<BS>>(out);
  }
  return cudaErrorInvalidValue;
}

template <int D>
cudaError_t at_dim(Op op, int dtype, int bs, const Args& a, int* out,
                   cudaStream_t s) {
  switch (bs) {
    case 8: return at_block<D, 8>(op, dtype, a, out, s);
    case 16: return at_block<D, 16>(op, dtype, a, out, s);
    case 32: return at_block<D, 32>(op, dtype, a, out, s);
    default: return cudaErrorInvalidValue;
  }
}

int run(Op op, int dtype, int d, int bs, const Args& a, int* out,
        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return (int)at_dim<64>(op, dtype, bs, a, out, s);
    case 80: return (int)at_dim<80>(op, dtype, bs, a, out, s);
    case 96: return (int)at_dim<96>(op, dtype, bs, a, out, s);
    case 128: return (int)at_dim<128>(op, dtype, bs, a, out, s);
    case 256: return (int)at_dim<256>(op, dtype, bs, a, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// K1.  q (B, KVH, G, d); pools (nb, bs, KVH, d); tables (B, mb) int32;
// seq_lens (B,) int32 (the query's position); out (B, KVH, G, d).
// dtype: 0 = float32, 1 = bfloat16.  Each (kv head, batch row, 8 query
// rows)'s live range is cut into `parts` (1..16) runs of blocks, a CTA
// each; parts > 1 needs the fp32 workspace of B * KVH * ceil(G / 8) *
// parts * 8 * (d + 2) floats.
int paged_decode_gqa(int dtype, int head_dim, int block_size, const void* q,
                     const void* k_pool, const void* v_pool,
                     const int* tables, const int* seq_lens, void* out, int B,
                     int KVH, int G, int mb, int window, float softcap,
                     float scale, int parts, void* workspace, void* stream) {
  Args a{q, k_pool, v_pool, tables, seq_lens, out, B, KVH, G, G, mb,
         window, softcap, scale, parts, workspace};
  return run(Op::kDecode, dtype, head_dim, block_size, a, nullptr, stream);
}

// Resources of K1's split-KV body for (dtype, head_dim, block_size)
// (launches nothing): out[5] = registers a thread, spill bytes a thread,
// shared memory bytes a CTA, CTAs resident on one SM, query rows a CTA.
int paged_decode_gqa_resources(int dtype, int head_dim, int block_size,
                               int* out) {
  const Args a{};
  return run(Op::kDecodeQuery, dtype, head_dim, block_size, a, out, nullptr);
}

// K2.  q (B, KVH, S*G, d) packed rows i*G + g; starts (B,) int32 (position
// of span token 0); out like q.  bf16 only: each row tile's keys split into
// `parts` (1..4) CTAs, workspace (fp32, parts > 1) of tiles x parts x 64 x
// (d + 2) floats, tiles = ceil(S*G / 64) * KVH * B; fp32 takes parts = 1.
int paged_prefill_gqa(int dtype, int head_dim, int block_size, const void* q,
                      const void* k_pool, const void* v_pool,
                      const int* tables, const int* starts, void* out, int B,
                      int KVH, int SG, int G, int mb, int window,
                      float softcap, float scale, int parts, void* workspace,
                      void* stream) {
  if (dtype == 0 && parts != 1) return (int)cudaErrorInvalidValue;
  Args a{q, k_pool, v_pool, tables, starts, out, B, KVH, SG, G, mb,
         window, softcap, scale, parts, workspace};
  return run(Op::kPrefill, dtype, head_dim, block_size, a, nullptr, stream);
}

// Resources of K2's bf16 (tensor-core) span body for (head_dim,
// block_size) (launches nothing): out[5] = registers a thread, spill bytes a
// thread, shared memory bytes a CTA, CTAs resident on one SM, packed query
// rows a CTA.
int paged_prefill_gqa_resources(int head_dim, int block_size, int* out) {
  const Args a{};
  return run(Op::kPrefillQuery, 1, head_dim, block_size, a, out, nullptr);
}

}  // extern "C"
