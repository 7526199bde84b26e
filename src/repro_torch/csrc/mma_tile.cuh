// The bf16 attention tile on Hopper's tensor cores, shared by K2 (span
// prefill over the paged pools, csrc/paged_attention.cu), K8 (block-sparse
// attention over the selected key blocks, csrc/block_sparse.cu) and K9
// (dense attention over contiguous keys, csrc/flash_attention.cu: the RL
// loop backend's re-forward).  K2's fp32 route keeps gqa_tile.cuh's SIMT
// body; K8's and K9's fp32 routes run tf32_tile.cuh's 3xTF32 tile, which
// walks its keys as this tile does and folds its parts with this file's
// combine kernel: this tile is the bf16 one, chosen by dtype in each
// kernel's dispatch.
//
// What bounds it on this card: arithmetic.  At the serve shapes (64 packed
// query rows against ~1000-2000 keys a CTA, d 128) a K/V byte staged in
// shared memory feeds 64 rows, far above the ~295 flop/byte ridge, so the
// tile must run QK^T and PV on the tensor cores, not on the CUDA cores'
// fp32 FMAs (67 TFLOP/s at best).
//
// What the design does about it:
//   * one CTA of 4 warps owns kRows = 64 packed query rows (row r: token
//     r / G, query head r % G of one KV head), a warp 16 of them; QK^T and
//     PV run on mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 with
//     fp32 accumulators in registers.  Q, K and V are read from shared
//     memory by ldmatrix (.trans for V); P never leaves the registers (the
//     QK^T accumulator of two 8-key tiles is the A fragment of PV, rounded
//     to bf16 there and only there, as the reference's model path does,
//     probs.astype(v.dtype)).  A bf16 x bf16 product is exact in the fp32
//     accumulator, so the scores are the Pallas kernels' fp32 scores up to
//     summation order; they are scaled in fp32 and then soft-capped, never
//     pre-scaled in bf16;
//   * where dv is above 128 (K8's MLA shape 192/256, K2's d 256) the
//     output columns are split over 2 groups of 4 warps: each computes the
//     same scores for its rows and accumulates half of PV, so no thread
//     holds more than a 16 x 128 accumulator (64 registers);
//   * K/V stay bf16 in shared memory, kKeys = 64 keys a round, brought in
//     by cp.async.cg 16-byte copies into kStages = 2 buffers (commit and
//     wait groups; no register staging): round r + 1's copies are issued
//     right after the barrier that opens round r, so they land while r
//     computes.  The rows are paged (K2: a 64-key round spans 2-8 pool
//     blocks of 8-32 tokens) or gathered (K8: flat key t is block
//     list[t / bs], offset t % bs), which defeats one TMA box a round; each
//     key row is its own run of 16-byte copies, which is what cp.async
//     does.  A round's key table (position and K/V row of each key, looked
//     up once a key, two rounds ahead, into a ring of kSlots) lets
//     consecutive threads copy consecutive 16 bytes of a row, so a warp's
//     copy touches 2-4 rows (16 rows a copy measured slower); a key past
//     the range is zero-filled by the copy itself (src-size 0), so a
//     masked p = 0 never meets stale memory;
//   * rows are padded by 8 bf16 (16 bytes): a row stride of 16 mod 128
//     bytes puts the 8 rows an ldmatrix phase reads on distinct banks;
//   * the card is filled by splitting each tile's key rounds into `parts`
//     (<= kMaxParts) CTAs: the serve shapes give 128 tiles for 132 SMs,
//     one warp a scheduler, while the tile holds 2 CTAs an SM (88 KB of
//     shared memory at d 128; the launch bounds say so, or ptxas spills to
//     fit a third CTA's registers).  The wrapper picks parts so
//     that one wave fills every CTA slot the occupancy query reports; each
//     part writes its (m, l, acc) to a workspace the wrapper allocates, and
//     a combine kernel (a CTA for 16 rows, every part's loads in flight)
//     folds them.  With parts = 1 the tile writes its output itself.
//     128-row CTAs of 8 warps (1 an SM by registers) and a third K/V
//     buffer measured slower;
//   * the softmax is the reference's online update in the log2 domain
//     (scores times log2 e, exp2f): masked entries count as NEG_INF in the
//     running max and contribute p = 0; a row that sees no key gets 0 or,
//     where the policy asks for it (K8's empty_mean), the mean of V over
//     the keys the policy names.  A round that every row of a warp sees
//     whole (K8's selected blocks before the span, K2's keys before the
//     diagonal; every round but the last of a non-causal K9 tile) skips
//     the mask.
// Not done yet (later work): wgmma (64-row warpgroup tiles read B from
// shared memory once for 64 rows, where mma.sync's ldmatrix reads it once a
// 16-row warp).
//
// Where the rows and keys live is the layout policy's (type KV):
//   kList, kMean        shared ints list_keys may fill; whether the policy
//                       has the empty-row mean (v_mean, empty_mean)
//   G, window           query heads a KV head; window (0: none)
//   causal()            whether a key after a query's position is masked
//   rows(y, z)          packed query rows of grid row (y, z)
//   pos0(y, z)          position of packed row 0's token
//   q_row / out_row(y, z, r)  row of packed row r's query (in units of
//                       DQK) and output (units of DV)
//   list_keys(y, z, q_first, q_last, list, range)   (thread 0) the flat key
//                       indices range[0] .. range[1] the tile reads
//   key(y, z, t, list, row)   position of flat key t, or kNoKey, and its
//                       K/V row (units of DQK / DV)

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {
namespace mma_tile {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;     // packed query rows a CTA: 4 warps x 16
constexpr int kKeys = 64;     // keys a round
constexpr int kStages = 2;    // K/V buffers: the round computed, the next
constexpr int kSlots = 3;     // key tables: those two and the one after
constexpr int kPad = 8;       // bf16 padding a shared-memory row
constexpr int kMaxParts = 4;  // key-range splits a tile
constexpr int kNoKey = 0x7fffffff;   // position of a key that is not there
constexpr float kNegInf = -1e30f;    // the reference kernels' NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

template <int DQK, int DV>
struct Tile {
  static constexpr int kWarpCols = DV < 128 ? DV : 128;  // output columns
  static constexpr int kColGroups = DV / kWarpCols;      // a warp's rows
  static constexpr int kThreads = 128 * kColGroups;
  // CTAs an SM the shared memory allows at the serve width (88 KB at
  // d 128): told to ptxas, so it does not trade spills for a third
  static constexpr int kCtasPerSm = kColGroups == 1 ? 2 : 1;
  static constexpr int kLdK = DQK + kPad;   // Q and K rows
  static constexpr int kLdV = DV + kPad;
  static constexpr size_t kSmem =
      ((size_t)kRows * kLdK + (size_t)kStages * kKeys * (kLdK + kLdV)) * 2
      + (size_t)kSlots * (2 * kKeys + 2) * sizeof(int);
  static_assert(DQK % 16 == 0 && kWarpCols % 16 == 0 &&
                DV % kWarpCols == 0, "tile shape");
};

__device__ inline uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !valid
__device__ inline void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}
__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ inline void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ inline void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate
__device__ inline void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ inline uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// a score in log2 units: scaled in fp32, then soft-capped c*tanh(s/c)
__device__ inline float log2_score(float s, float scale, float softcap) {
  float x = s * scale;
  if (softcap > 0.f) x = softcap * tanhf(x / softcap);
  return x * kLog2e;
}

__device__ inline void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// the workspace of a split launch: (m, l) of every (tile, part, row), then
// the unnormalised accumulators
__device__ inline size_t ws_rows(int tile, int parts, int part) {
  return ((size_t)tile * parts + part) * kRows;
}

template <int DQK, int DV, typename KV>
__global__ void __launch_bounds__(Tile<DQK, DV>::kThreads,
                                  Tile<DQK, DV>::kCtasPerSm)
attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 float* __restrict__ ws, KV layout, int parts, float softcap,
                 float scale) {
  using Tl = Tile<DQK, DV>;
  constexpr int NT = Tl::kThreads, LDK = Tl::kLdK, LDV = Tl::kLdV;
  constexpr int WC = Tl::kWarpCols;
  constexpr int KCH = DQK / 8, VCH = DV / 8;  // 16-byte chunks a row
  static_assert(NT >= kKeys, "key table");

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kRows * LDK;              // [kStages][kKeys][LDK]
  bf16* Vs = Ks + kStages * kKeys * LDK;    // [kStages][kKeys][LDV]
  int* Kpos = reinterpret_cast<int*>(Vs + kStages * kKeys * LDV);
  int* Krow = Kpos + kSlots * kKeys;        // [kSlots][kKeys] each
  int* Kmax = Krow + kSlots * kKeys;        // [kSlots][2]
  __shared__ int s_list[KV::kList];
  __shared__ int s_range[2];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int part = blockIdx.x % parts, x = blockIdx.x / parts;
  const int y = blockIdx.y, z = blockIdx.z;
  const int G = layout.G;
  const int r0 = x * kRows;
  const int rows = min(kRows, layout.rows(y, z) - r0);
  const int pos0 = layout.pos0(y, z);
  if (tid == 0)
    layout.list_keys(y, z, pos0 + r0 / G, pos0 + (r0 + rows - 1) / G,
                     s_list, s_range);

  // this tile's queries; rows past `rows` are zero-filled and never written
  for (int i = tid; i < kRows * KCH; i += NT) {
    const int r = i / KCH, c = (i % KCH) * 8;
    const bool ok = r < rows;
    cp_async16(Qs + r * LDK + c,
               q + (ok ? layout.q_row(y, z, r0 + r) : 0) * DQK + c, ok);
  }
  __syncthreads();  // s_range / s_list
  const int lo = s_range[0], hi = s_range[1];
  const int rounds = hi >= lo ? (hi - lo) / kKeys + 1 : 0;
  const int rb = rounds * part / parts, re = rounds * (part + 1) / parts;

  // the key table of round rd (a thread a key, two warps): its position
  // (kNoKey past the range) and K/V row, and each warp's largest position,
  // in slot (rd - rb) % kSlots
  auto look_up = [&](int rd) {
    if (tid >= kKeys || rd >= re) return;
    const int t = lo + rd * kKeys + tid;
    const int slot = (rd - rb) % kSlots;
    size_t row = 0;
    const int pos = t <= hi ? layout.key(y, z, t, s_list, row) : kNoKey;
    Kpos[slot * kKeys + tid] = pos;
    Krow[slot * kKeys + tid] = (int)row;
    const int most = __reduce_max_sync(0xffffffffu, pos);
    if (lane == 0) Kmax[slot * 2 + warp] = most;
  };
  // round rd's K/V into stage (rd - rb) % kStages from its key table:
  // consecutive threads copy consecutive 16 bytes of a row, so a warp's
  // copy touches 2-4 rows; a key that is not there is zero-filled
  auto issue = [&](int rd) {
    if (rd >= re) return;
    const int* pos = Kpos + ((rd - rb) % kSlots) * kKeys;
    const int* row = Krow + ((rd - rb) % kSlots) * kKeys;
    const int st = (rd - rb) % kStages;
    for (int i = tid; i < kKeys * KCH; i += NT) {
      const int j = i / KCH, c = (i % KCH) * 8;
      cp_async16(Ks + (st * kKeys + j) * LDK + c,
                 k + (size_t)row[j] * DQK + c, pos[j] != kNoKey);
    }
    for (int i = tid; i < kKeys * VCH; i += NT) {
      const int j = i / VCH, c = (i % VCH) * 8;
      cp_async16(Vs + (st * kKeys + j) * LDV + c,
                 v + (size_t)row[j] * DV + c, pos[j] != kNoKey);
    }
  };

  look_up(rb);
  look_up(rb + 1);
  __syncthreads();
  issue(rb);
  cp_async_commit();  // the queries and the first round

  const int rg = warp % 4, cg = warp / 4;  // row group, column group
  const int qr = rg * 16 + lane / 4;       // this thread's rows qr, qr + 8
  const int qp0 = pos0 + (r0 + qr) / G, qp1 = pos0 + (r0 + qr + 8) / G;
  const int q_warp = pos0 + (r0 + rg * 16) / G;  // the warp's first query
  const int window = layout.window;
  // the last key position rows qr and qr + 8 and the warp's first row
  // see: their query's when causal (K2, K8: one compare, p <= qpos), else
  // any key that is there (kNoKey, INT_MAX, marks one that is not)
  const bool causal = layout.causal();
  const int last0 = causal ? qp0 : kNoKey - 1;
  const int last1 = causal ? qp1 : kNoKey - 1;
  const int last_warp = causal ? q_warp : kNoKey - 1;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[WC / 8][4];
#pragma unroll
  for (int n = 0; n < WC / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int rd = rb; rd < re; ++rd) {
    const int st = (rd - rb) % kStages;
    cp_async_wait<0>();
    // round rd has landed (every thread's copies), round rd + 1's key table
    // is written, and every reader of the stage and the slot refilled below
    // (round rd - 1's) is done
    __syncthreads();
    issue(rd + 1);
    cp_async_commit();
    look_up(rd + 2);

    // S = Q K^T: 16 rows x 64 keys a warp, fp32
    const bf16* Kst = Ks + st * kKeys * LDK;
    float s[kKeys / 8][4];
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DQK; kk += 16) {
      uint32_t a[4];
      ldsm_x4(a, Qs + (rg * 16 + lane % 16) * LDK + kk + (lane / 16) * 8);
#pragma unroll
      for (int n2 = 0; n2 < kKeys / 16; ++n2) {
        uint32_t b[4];
        ldsm_x4(b, Kst + (n2 * 16 + lane % 8 + (lane / 16) * 8) * LDK + kk
                       + ((lane / 8) % 2) * 8);
        mma16816(s[2 * n2], a, b[0], b[1]);
        mma16816(s[2 * n2 + 1], a, b[2], b[3]);
      }
    }

    // scale, soft-cap, mask (-inf), in log2 units; the online max.  A
    // round that every row of the warp sees whole (no window, every key
    // there and, when causal, at or before the warp's first query) takes
    // no mask
    const int slot = (rd - rb) % kSlots;
    const int* kp = Kpos + slot * kKeys;
    float mx[2] = {-INFINITY, -INFINITY};
    if (window <= 0 &&
        max(Kmax[slot * 2], Kmax[slot * 2 + 1]) <= last_warp) {
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = log2_score(s[n][e], scale, softcap);
          mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
        }
      }
    } else {
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = kp[n * 8 + (lane % 4) * 2 + (e & 1)];
          const int qpos = e < 2 ? qp0 : qp1;
          const bool ok = p <= (e < 2 ? last0 : last1) &&
                          (window <= 0 || qpos - p < window);
          s[n][e] = ok ? log2_score(s[n][e], scale, softcap) : -INFINITY;
          mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
        }
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];   // this thread's share; summed over the quad last
    }
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - m[e / 2]);   // masked: exp2(-inf) = 0
        l[e / 2] += s[n][e];
      }
    }
#pragma unroll
    for (int n = 0; n < WC / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // acc += P V over this column group's columns, P in bf16
    const bf16* Vst = Vs + st * kKeys * LDV + cg * WC;
#pragma unroll
    for (int kt = 0; kt < kKeys / 16; ++kt) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kt][0], s[2 * kt][1]);
      a[1] = pack_bf16(s[2 * kt][2], s[2 * kt][3]);
      a[2] = pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]);
      a[3] = pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3]);
#pragma unroll
      for (int n2 = 0; n2 < WC / 16; ++n2) {
        uint32_t b[4];
        ldsm_x4_trans(b, Vst + (kt * 16 + lane % 8 + ((lane / 8) % 2) * 8)
                                   * LDV + n2 * 16 + (lane / 16) * 8);
        mma16816(acc[2 * n2], a, b[0], b[1]);
        mma16816(acc[2 * n2 + 1], a, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();  // a part with no round still has the queries' group

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const int col0 = cg * WC + (lane % 4) * 2;

  if (parts > 1) {  // this part's (m, l, acc) for the combine kernel
    const int tile = (z * gridDim.y + y) * (gridDim.x / parts) + x;
    const size_t ntiles = (size_t)(gridDim.x / parts) * gridDim.y * gridDim.z;
    float* ml = ws + ws_rows(tile, parts, part) * 2;
    float* wacc = ws + ntiles * parts * kRows * 2
                  + ws_rows(tile, parts, part) * DV;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = qr + 8 * i;
      if (r >= rows) continue;
      if (cg == 0 && lane % 4 == 0) {
        ml[2 * r] = m[i];
        ml[2 * r + 1] = l[i];
      }
#pragma unroll
      for (int n = 0; n < WC / 8; ++n)
        *reinterpret_cast<float2*>(wacc + (size_t)r * DV + col0 + n * 8) =
            make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
    }
    return;
  }

  // a row that saw no key: 0, or the policy's mean of V (the barrier also
  // ends every warp's last round before vmean takes its shared memory)
  float* vmean = reinterpret_cast<float*>(Ks);
  bool mean = false;
  if constexpr (KV::kMean) {
    const bool empty = (qr < rows && l[0] == 0.f) ||
                       (qr + 8 < rows && l[1] == 0.f);
    mean = __syncthreads_or(empty) && layout.empty_mean;
    if (mean) {
      for (int c = tid; c < DV; c += NT) vmean[c] = layout.v_mean(v, y, z, c);
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = qr + 8 * i;
    if (r >= rows) continue;
    bf16* o = out + layout.out_row(y, z, r0 + r) * DV;
#pragma unroll
    for (int n = 0; n < WC / 8; ++n) {
      const int c = col0 + n * 8;
      float a = 0.f, b = 0.f;
      if (l[i] > 0.f) {
        a = acc[n][2 * i] / l[i];
        b = acc[n][2 * i + 1] / l[i];
      } else if (mean) {
        a = vmean[c];
        b = vmean[c + 1];
      }
      store_pair(o + c, a, b);
    }
  }
}

// 4 output columns in the output's type (bf16: K2, K8; fp32: K4's MLA tile)
__device__ inline void store4(bf16* p, const float (&o)[4]) {
  store_pair(p, o[0], o[1]);
  store_pair(p + 2, o[2], o[3]);
}
__device__ inline void store4(float* p, const float (&o)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}

// Fold the parts of a split launch: a CTA for kFoldRows rows of a tile, a
// thread for 4 columns of a row at a time, every part's loads issued before
// they are used; out = sum_p 2^(m_p - M) acc_p / sum_p 2^(m_p - M) l_p.
// The workspace is any tile's whose parts write it as attention_kernel's
// do (K4's tile in paged_mla.cu too, with fp32 output rows; tf32_tile.cuh's,
// fp32 output rows and V).
constexpr int kFoldRows = 16;

template <int DV, typename KV, typename TO = bf16, typename TV = bf16>
__global__ void __launch_bounds__(128)
combine_kernel(const float* __restrict__ ws, const TV* __restrict__ v,
               TO* __restrict__ out, KV layout, int parts) {
  constexpr int kSplits = kRows / kFoldRows;   // CTAs a tile
  __shared__ float w[kFoldRows][kMaxParts];
  __shared__ float lsum[kFoldRows];
  __shared__ float vmean[DV];
  const int tid = threadIdx.x;
  const int x = blockIdx.x / kSplits, y = blockIdx.y, z = blockIdx.z;
  const int f0 = (blockIdx.x % kSplits) * kFoldRows;  // first row folded
  const int r0 = x * kRows;
  const int rows = min(kFoldRows, layout.rows(y, z) - r0 - f0);
  if (rows <= 0) return;
  const int tile = (z * gridDim.y + y) * (gridDim.x / kSplits) + x;
  const size_t ntiles = (size_t)(gridDim.x / kSplits) * gridDim.y * gridDim.z;
  const float* ml = ws + ws_rows(tile, parts, 0) * 2;
  const float* acc = ws + ntiles * parts * kRows * 2
                     + ws_rows(tile, parts, 0) * DV;

  bool empty = false;
  if (tid < rows) {
    const int r = f0 + tid;
    float M = kNegInf;
    for (int p = 0; p < parts; ++p) M = fmaxf(M, ml[(p * kRows + r) * 2]);
    float L = 0.f;
    for (int p = 0; p < parts; ++p) {
      const float wp = exp2f(ml[(p * kRows + r) * 2] - M);
      w[tid][p] = wp;
      L += wp * ml[(p * kRows + r) * 2 + 1];
    }
    lsum[tid] = L;
    empty = L == 0.f;
  }
  bool mean = false;
  if constexpr (KV::kMean) {
    mean = __syncthreads_or(empty) && layout.empty_mean;
    if (mean)
      for (int c = tid; c < DV; c += blockDim.x)
        vmean[c] = layout.v_mean(v, y, z, c);
  }
  __syncthreads();
  for (int i = tid; i < rows * (DV / 4); i += blockDim.x) {
    const int r = i / (DV / 4), c = (i % (DV / 4)) * 4;
    float4 f[kMaxParts];
#pragma unroll
    for (int p = 0; p < kMaxParts; ++p)
      if (p < parts)
        f[p] = *reinterpret_cast<const float4*>(
            acc + ((size_t)p * kRows + f0 + r) * DV + c);
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    const float L = lsum[r];
    if (L > 0.f) {
#pragma unroll
      for (int p = 0; p < kMaxParts; ++p) {
        if (p < parts) {
          o[0] += w[r][p] * f[p].x;
          o[1] += w[r][p] * f[p].y;
          o[2] += w[r][p] * f[p].z;
          o[3] += w[r][p] * f[p].w;
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) o[u] /= L;
    } else if (mean) {
#pragma unroll
      for (int u = 0; u < 4; ++u) o[u] = vmean[c + u];
    }
    store4(out + layout.out_row(y, z, r0 + f0 + r) * DV + c, o);
  }
}

// Once per instantiation: a function-local static is initialised exactly
// once even when two host threads make the first launch at once (K9's bf16
// route is reached from the RL workers' threads and the trainer's).
template <int DQK, int DV, typename KV>
cudaError_t configure() {
  static const cudaError_t e = cudaFuncSetAttribute(
      attention_kernel<DQK, DV, KV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tile<DQK, DV>::kSmem);
  return e;
}

// Launch the tile over its (row tiles of kRows, ny, nz) CTAs, each split
// into `parts` CTAs over its keys (parts > 1 needs the workspace: tiles x
// parts x kRows x (DV + 2) floats), then the combine pass where parts > 1.
template <int DQK, int DV, typename KV>
cudaError_t launch_attention(const void* q, const void* k, const void* v,
                             void* out, void* ws, const KV& layout, int rows,
                             int ny, int nz, int parts, float softcap,
                             float scale, cudaStream_t stream) {
  using Tl = Tile<DQK, DV>;
  if (parts < 1 || parts > kMaxParts || (parts > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  cudaError_t e = configure<DQK, DV, KV>();
  if (e != cudaSuccess) return e;
  const dim3 tiles((rows + kRows - 1) / kRows, ny, nz);
  const dim3 grid(tiles.x * parts, ny, nz);
  attention_kernel<DQK, DV, KV><<<grid, Tl::kThreads, Tl::kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(ws), layout, parts, softcap, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || parts == 1) return e;
  const dim3 folds(tiles.x * (kRows / kFoldRows), ny, nz);
  combine_kernel<DV, KV><<<folds, 128, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), layout, parts);
  return cudaGetLastError();
}

// out = {registers a thread, local (spill) bytes a thread, shared memory
// bytes a CTA, CTAs resident on one SM (as the runtime reports them),
// packed query rows a CTA} of the tile kernel
template <int DQK, int DV, typename KV>
cudaError_t resources(int* out) {
  using Tl = Tile<DQK, DV>;
  cudaError_t e = configure<DQK, DV, KV>();
  if (e != cudaSuccess) return e;
  auto kern = attention_kernel<DQK, DV, KV>;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kern);
  if (e != cudaSuccess) return e;
  int ctas = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kern, Tl::kThreads,
                                                    Tl::kSmem);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)(Tl::kSmem + attr.sharedSizeBytes);
  out[3] = ctas;
  out[4] = kRows;
  return e;
}

}  // namespace mma_tile
}  // namespace
