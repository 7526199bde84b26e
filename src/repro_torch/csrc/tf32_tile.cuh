// The fp32 attention tile on Hopper's tensor cores by 3xTF32, shared by K9's
// fp32 route (csrc/flash_attention.cu, the training path's dense attention)
// and K8's (csrc/block_sparse.cu, the block selector's attention over the
// selected key blocks: the DSA training chunks and the fp32 parity runs).
// K8's and K9's bf16 routes run mma_tile.cuh; fp32 K2 keeps gqa_tile.cuh's
// SIMT body.  Its TF32 helpers split and mma1688 (and the cp.async ones it
// takes from mma_tile.cuh) also serve K10's fp32 logits tile
// (csrc/chunked_ce.cu).
//
// What bounds it on this card: arithmetic.  K9's training shape (Yi-6B: B
// 2, S 2048, H 32 / KVH 4, d 128, causal) is 6.87e10 flops against 0.2 GB
// of q/k/v/out; K8's training chunk (S 256 against 16 selected blocks of
// 128 keys, H 32 / KVH 4, d 128) is 8.6e9 against ~10 MB.  The trainer
// keeps TF32 off, since its parity contract is fp32, so a single TF32
// product is not allowed; on the CUDA cores fp32 runs at 67 TFLOP/s at
// best (K9 1.03 ms, K8 0.128).  3xTF32 writes each fp32 operand as big +
// small, two TF32 values (big = x rounded to TF32 as cvt.rna.tf32 rounds,
// small = x - big rounded the same way: together x to ~2^-22 relative), and
// sums three tensor-core products, big.big + big.small + small.big, in fp32
// accumulators: only small.small (~2^-22 of a product) is dropped.  Three
// products at the TF32 rate (495 TFLOP/s) bound K9's shape at 0.417 ms and
// K8's chunk at 0.052.
//
// What the design does about it:
//   * one CTA of 4 warps owns kRows = 64 packed query rows (row r: token
//     r / G, query head r % G of one KV head), a warp 16 of them; QK^T and
//     PV run on mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, three
//     products each.  Where dv is above 128 (K8's MLA shape 192 / 256, K9's
//     d 256) the output columns split over 2 groups of 4 warps, each
//     computing the same scores (no thread holds more than a 16 x 128
//     accumulator: 64 registers);
//   * Q, K and V stay fp32 in shared memory (cp.async 16-byte copies, K/V
//     in a 2-buffer ring of kKeys keys a round) and are split when a
//     fragment is loaded.  The keys are walked as mma_tile.cuh walks them:
//     flat key indices from the layout's list_keys, each key's position and
//     K/V row looked up once, two rounds ahead, into a key table of kSlots
//     rounds (K9's keys are contiguous positions, K8's the listed blocks'
//     keys); a key past the range is zero-filled by the copy, so a masked
//     p = 0 never meets stale memory;
//   * ldmatrix does not transpose 32-bit elements, so fragments come from
//     plain 32-bit shared loads.  The k index of a fragment is permuted:
//     k = t of a quad's thread t stands for element 2t of the 8, k = t + 4
//     for element 2t + 1.  A and B of QK^T then come as float2 loads of
//     adjacent dims (row pad 8 floats: a half-warp's 16 float2 loads cover
//     32 distinct banks), the QK^T accumulator's (c0, c1, c2, c3) is PV's A
//     fragment (P[g][2t], P[g+8][2t], P[g][2t+1], P[g+8][2t+1]) without a
//     shuffle, and V's B fragment reads keys 2t and 2t + 1 of a column (row
//     pad 4 floats: the 32 loads of a warp hit 32 banks);
//   * the grid is one-dimensional and walks the key-range parts fastest,
//     then the (y, z) grid rows, then the query tiles from the last: K9's
//     causal tiles differ 32-fold in their keys, so its longest start
//     first;
//   * the card is filled as mma_tile.cuh fills it: each tile's key rounds
//     split over `parts` (<= kMaxParts) CTAs, each writing its (m, l, acc)
//     to an fp32 workspace that mma_tile.cuh's combine kernel folds (and
//     gives a row with no key the layout's mean of V).  K8's training
//     chunk has 128 tiles for the 264 CTA slots of 2 an SM; K9's causal
//     grid fills the card by itself and takes parts = 1;
//   * the softmax is mma_tile.cuh's: scores scaled in fp32, soft-capped
//     c*tanh(s/c) before masking, log2 domain (exp2f), masked entries -inf
//     (p = 0), NEG_INF the running max's start; a row that sees no key gets
//     0 or, where the layout asks for it (K8's empty_mean), its mean of V;
//     a round that every row of the warp sees whole (no window, every key
//     there and, when causal, at or before the warp's first query: K8's
//     selected blocks before the span, K9's keys before the diagonal)
//     skips the mask.
// The keys a round are a compile-time knob (REPRO_TF32_KEYS, 32 or 64 when
// both widths are <= 128; wider tiles take 32, the only size that fits) so
// tile_study.py can build and time the other.  Not done yet (later work):
// wgmma (a 64-row warpgroup reads B from shared memory once, mma.sync's
// warps once each).
//
// Where the rows and keys live is the layout policy's (type KV), the
// interface of mma_tile.cuh's tile (kList, kMean, G, window, rows, pos0,
// q_row, out_row, list_keys, key, and v_mean / empty_mean where kMean)
// and causal(): whether a key after a query's position is masked.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "mma_tile.cuh"

#ifndef REPRO_TF32_KEYS
#define REPRO_TF32_KEYS 32
#endif

namespace {
namespace tf32_tile {

// the cp.async helpers, the softmax's score, the key table and the split of
// the bf16 tile
using mma_tile::cp_async16;
using mma_tile::cp_async_commit;
using mma_tile::cp_async_wait;
using mma_tile::kMaxParts;
using mma_tile::kNegInf;
using mma_tile::kNoKey;
using mma_tile::kRows;
using mma_tile::kSlots;
using mma_tile::log2_score;
using mma_tile::ws_rows;

constexpr int kStages = 2;    // K/V buffers: the round computed, the next

template <int DQK, int DV>
struct Tile {
  static constexpr int kKeys =
      DQK <= 128 && DV <= 128 ? REPRO_TF32_KEYS : 32;
  static constexpr int kTableWarps = kKeys / 32;   // warps of a key table
  static constexpr int kWarpCols = DV < 128 ? DV : 128;
  static constexpr int kColGroups = DV / kWarpCols;
  static constexpr int kThreads = 128 * kColGroups;
  static constexpr int kLdK = DQK + 8;   // Q and K rows (floats)
  static constexpr int kLdV = DV + 4;    // V rows
  static constexpr size_t kSmem =
      ((size_t)kRows * kLdK + (size_t)kStages * kKeys * (kLdK + kLdV)) * 4
      + (size_t)kSlots * (2 * kKeys + kTableWarps) * sizeof(int);
  // CTAs an SM the shared memory allows (2 at d 128 with 32 keys a round,
  // 1 at K8's 192 / 256: 170 KB): told to ptxas, so it does not trade
  // spills for more
  static constexpr int kCtasPerSm = 2 * (kSmem + 1024) <= 228 * 1024 ? 2 : 1;
  static_assert(DQK % 8 == 0 && kKeys % 32 == 0 && kWarpCols % 8 == 0 &&
                DV % kWarpCols == 0 && kThreads >= kKeys, "tile shape");
};

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero), bit for bit on finite values, by two integer ops: half of the
// dropped 13 bits' range added to the magnitude, then cleared.  The cvt
// instruction measured 19 % (K9) and 15-30 % (K10) slower on the card.
__device__ inline uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small, both TF32
__device__ inline void split(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// c += a (16x8, row) * b (8x8, col), TF32 in, fp32 accumulate
__device__ inline void mma1688(float (&c)[4], const uint32_t (&a)[4],
                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b by 3xTF32: the two small terms first, then big.big
__device__ inline void mma3(float (&c)[4], const uint32_t (&ab)[4],
                            const uint32_t (&as)[4], uint32_t bb0,
                            uint32_t bb1, uint32_t bs0, uint32_t bs1) {
  mma1688(c, as, bb0, bb1);
  mma1688(c, ab, bs0, bs1);
  mma1688(c, ab, bb0, bb1);
}

template <int DQK, int DV, typename KV>
__global__ void __launch_bounds__(Tile<DQK, DV>::kThreads,
                                  Tile<DQK, DV>::kCtasPerSm)
attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ ws, KV layout, int tiles, int ny,
                 int nz, int parts, float softcap, float scale) {
  using Tl = Tile<DQK, DV>;
  constexpr int NT = Tl::kThreads, LDK = Tl::kLdK, LDV = Tl::kLdV;
  constexpr int KN = Tl::kKeys, WC = Tl::kWarpCols, TW = Tl::kTableWarps;
  constexpr int QCH = DQK / 4, VCH = DV / 4;   // 16-byte chunks a row

  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + kRows * LDK;              // [kStages][KN][LDK]
  float* Vs = Ks + kStages * KN * LDK;       // [kStages][KN][LDV]
  int* Kpos = reinterpret_cast<int*>(Vs + kStages * KN * LDV);
  int* Krow = Kpos + kSlots * KN;            // [kSlots][KN] each
  int* Kmax = Krow + kSlots * KN;            // [kSlots][TW]
  __shared__ int s_list[KV::kList];
  __shared__ int s_range[2];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  // parts fastest, then the (y, z) grid rows, the query tiles from the last
  const int part = (int)(blockIdx.x % parts), c = (int)(blockIdx.x / parts);
  const int others = ny * nz;
  const int x = tiles - 1 - c / others;
  const int y = c % others % ny, z = c % others / ny;
  const int G = layout.G;
  const int r0 = x * kRows;
  const int rows = min(kRows, layout.rows(y, z) - r0);
  const int pos0 = layout.pos0(y, z);
  if (tid == 0)
    layout.list_keys(y, z, pos0 + r0 / G, pos0 + (r0 + rows - 1) / G,
                     s_list, s_range);

  // this tile's queries; rows past `rows` are zero-filled and never written
  for (int i = tid; i < kRows * QCH; i += NT) {
    const int r = i / QCH, e = (i % QCH) * 4;
    const bool ok = r < rows;
    cp_async16(Qs + r * LDK + e,
               q + (ok ? layout.q_row(y, z, r0 + r) : 0) * DQK + e, ok);
  }
  __syncthreads();  // s_range / s_list
  const int lo = s_range[0], hi = s_range[1];
  const int rounds = hi >= lo ? (hi - lo) / KN + 1 : 0;
  const int rb = rounds * part / parts, re = rounds * (part + 1) / parts;

  // the key table of round rd (a thread a key): its position (kNoKey past
  // the range) and K/V row, and each table warp's largest position, in slot
  // (rd - rb) % kSlots
  auto look_up = [&](int rd) {
    if (tid >= KN || rd >= re) return;
    const int t = lo + rd * KN + tid;
    const int slot = (rd - rb) % kSlots;
    size_t row = 0;
    const int pos = t <= hi ? layout.key(y, z, t, s_list, row) : kNoKey;
    Kpos[slot * KN + tid] = pos;
    Krow[slot * KN + tid] = (int)row;
    const int most = __reduce_max_sync(0xffffffffu, pos);
    if (lane == 0) Kmax[slot * TW + warp] = most;
  };
  // round rd's K/V into stage (rd - rb) % kStages from its key table; a key
  // that is not there is zero-filled.  Where K and V rows are as wide, one
  // walk copies both (each key's table entry read once: two walks measured
  // ~5 % slower on K9's training shape on an H100)
  auto issue = [&](int rd) {
    if (rd >= re) return;
    const int* pos = Kpos + ((rd - rb) % kSlots) * KN;
    const int* row = Krow + ((rd - rb) % kSlots) * KN;
    const int st = (rd - rb) % kStages;
    for (int i = tid; i < KN * QCH; i += NT) {
      const int j = i / QCH, e = (i % QCH) * 4;
      const bool ok = pos[j] != kNoKey;
      cp_async16(Ks + (st * KN + j) * LDK + e,
                 k + (size_t)row[j] * DQK + e, ok);
      if constexpr (DQK == DV)
        cp_async16(Vs + (st * KN + j) * LDV + e,
                   v + (size_t)row[j] * DV + e, ok);
    }
    if constexpr (DQK != DV) {
      for (int i = tid; i < KN * VCH; i += NT) {
        const int j = i / VCH, e = (i % VCH) * 4;
        cp_async16(Vs + (st * KN + j) * LDV + e,
                   v + (size_t)row[j] * DV + e, pos[j] != kNoKey);
      }
    }
  };
  look_up(rb);
  look_up(rb + 1);
  __syncthreads();
  issue(rb);
  cp_async_commit();  // the queries and the first round

  const int rg = warp % 4, cg = warp / 4;   // row group, column group
  const int qr = rg * 16 + g;               // this thread's rows qr, qr + 8
  const int qp0 = pos0 + (r0 + qr) / G, qp1 = pos0 + (r0 + qr + 8) / G;
  const int q_warp = pos0 + (r0 + rg * 16) / G;   // the warp's first query
  const bool causal = layout.causal();
  const int window = layout.window;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[WC / 8][4];
#pragma unroll
  for (int n = 0; n < WC / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int rd = rb; rd < re; ++rd) {
    const int st = (rd - rb) % kStages, slot = (rd - rb) % kSlots;
    cp_async_wait<0>();
    // round rd has landed (every thread's copies), round rd + 1's key table
    // is written, and every reader of the stage and the slot refilled below
    // (round rd - 1's) is done
    __syncthreads();
    issue(rd + 1);
    cp_async_commit();
    look_up(rd + 2);

    // S = Q K^T: 16 rows x KN keys a warp, fp32 by 3xTF32
    const float* Kst = Ks + st * KN * LDK;
    float s[KN / 8][4];
#pragma unroll
    for (int n = 0; n < KN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < DQK; kk += 8) {
      const float2 x0 =
          *reinterpret_cast<const float2*>(Qs + qr * LDK + kk + 2 * t4);
      const float2 x1 =
          *reinterpret_cast<const float2*>(Qs + (qr + 8) * LDK + kk + 2 * t4);
      uint32_t ab[4], as[4];
      split(x0.x, ab[0], as[0]);
      split(x1.x, ab[1], as[1]);
      split(x0.y, ab[2], as[2]);
      split(x1.y, ab[3], as[3]);
#pragma unroll
      for (int n = 0; n < KN / 8; ++n) {
        const float2 kv = *reinterpret_cast<const float2*>(
            Kst + (n * 8 + g) * LDK + kk + 2 * t4);
        uint32_t bb0, bs0, bb1, bs1;
        split(kv.x, bb0, bs0);
        split(kv.y, bb1, bs1);
        mma3(s[n], ab, as, bb0, bb1, bs0, bs1);
      }
    }

    // scale, soft-cap, mask (-inf), in log2 units; the online max.  A
    // round that every row of the warp sees whole takes no mask
    const int* kp = Kpos + slot * KN;
    int most = Kmax[slot * TW];   // the round's largest position, or kNoKey
#pragma unroll
    for (int w = 1; w < TW; ++w) most = max(most, Kmax[slot * TW + w]);
    float mx[2] = {-INFINITY, -INFINITY};
    if (window <= 0 && (causal ? most <= q_warp : most != kNoKey)) {
#pragma unroll
      for (int n = 0; n < KN / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = log2_score(s[n][e], scale, softcap);
          mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
        }
      }
    } else {
#pragma unroll
      for (int n = 0; n < KN / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = kp[n * 8 + 2 * t4 + (e & 1)];
          const int qpos = e < 2 ? qp0 : qp1;
          const bool ok = p != kNoKey && (!causal || p <= qpos) &&
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
    for (int n = 0; n < KN / 8; ++n) {
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

    // acc += P V over this column group's columns, fp32 by 3xTF32: the
    // score tile of keys n*8 .. n*8+7 is the A fragment of that k-step
    const float* Vst = Vs + st * KN * LDV + cg * WC + g;
#pragma unroll
    for (int n = 0; n < KN / 8; ++n) {
      uint32_t ab[4], as[4];
      split(s[n][0], ab[0], as[0]);   // P[g][2t]       (k = t)
      split(s[n][2], ab[1], as[1]);   // P[g + 8][2t]
      split(s[n][1], ab[2], as[2]);   // P[g][2t + 1]   (k = t + 4)
      split(s[n][3], ab[3], as[3]);   // P[g + 8][2t + 1]
      const float* vr = Vst + (n * 8 + 2 * t4) * LDV;
#pragma unroll
      for (int cc = 0; cc < WC / 8; ++cc) {
        uint32_t bb0, bs0, bb1, bs1;
        split(vr[cc * 8], bb0, bs0);
        split(vr[LDV + cc * 8], bb1, bs1);
        mma3(acc[cc], ab, as, bb0, bb1, bs0, bs1);
      }
    }
  }
  cp_async_wait<0>();  // a part with no round still has the queries' group

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const int col0 = cg * WC + 2 * t4;

  if (parts > 1) {  // this part's (m, l, acc) for the combine kernel
    const int tile = (z * ny + y) * tiles + x;
    const size_t ntiles = (size_t)tiles * ny * nz;
    float* ml = ws + ws_rows(tile, parts, part) * 2;
    float* wacc = ws + ntiles * parts * kRows * 2
                  + ws_rows(tile, parts, part) * DV;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = qr + 8 * i;
      if (r >= rows) continue;
      if (cg == 0 && t4 == 0) {
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

  // a row that saw no key: 0, or the layout's mean of V (the barrier also
  // ends every warp's last round before vmean takes its shared memory)
  float* vmean = Ks;
  bool mean = false;
  if constexpr (KV::kMean) {
    const bool empty = (qr < rows && l[0] == 0.f) ||
                       (qr + 8 < rows && l[1] == 0.f);
    mean = __syncthreads_or(empty) && layout.empty_mean;
    if (mean) {
      for (int cv = tid; cv < DV; cv += NT)
        vmean[cv] = layout.v_mean(v, y, z, cv);
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = qr + 8 * i;
    if (r >= rows) continue;
    const bool use_mean = mean && l[i] == 0.f;
    const float inv = 1.f / fmaxf(l[i], 1e-20f);
    float* o = out + layout.out_row(y, z, r0 + r) * DV + col0;
#pragma unroll
    for (int n = 0; n < WC / 8; ++n)
      *reinterpret_cast<float2*>(o + n * 8) =
          use_mean ? make_float2(vmean[col0 + n * 8], vmean[col0 + n * 8 + 1])
                   : make_float2(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
  }
}

template <int DQK, int DV, typename KV>
cudaError_t configure() {
  static bool done = false;  // once per instantiation
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      attention_kernel<DQK, DV, KV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tile<DQK, DV>::kSmem);
  done = e == cudaSuccess;
  return e;
}

// Launch the tile over the ceil(rows / kRows) query tiles of each of the
// ny x nz grid rows, longest first, each split into `parts` CTAs over its
// keys (parts > 1 needs the workspace: tiles x parts x kRows x (DV + 2)
// floats), then mma_tile.cuh's combine pass where parts > 1.  The
// arguments are mma_tile::launch_attention's.
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
  const int tiles = (rows + kRows - 1) / kRows;
  const long long ctas = (long long)tiles * ny * nz * parts;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  attention_kernel<DQK, DV, KV><<<(unsigned)ctas, Tl::kThreads, Tl::kSmem,
                                  stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(ws), layout, tiles, ny, nz, parts, softcap, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || parts == 1) return e;
  const dim3 folds(tiles * (kRows / mma_tile::kFoldRows), ny, nz);
  mma_tile::combine_kernel<DV, KV, float, float><<<folds, 128, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<const float*>(v),
      static_cast<float*>(out), layout, parts);
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

}  // namespace tf32_tile
}  // namespace
