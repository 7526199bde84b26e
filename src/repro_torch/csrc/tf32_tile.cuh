// The fp32 attention tile on Hopper's tensor cores by 3xTF32: K9's fp32
// route (csrc/flash_attention.cu, the training path's dense attention).
// K9's bf16 route and fp32 K2 keep gqa_tile.cuh's SIMT body.  Its TF32
// helpers split and mma1688 (and the cp.async ones it takes from
// mma_tile.cuh) also serve K10's fp32 logits tile (csrc/chunked_ce.cu).
//
// What bounds it on this card: arithmetic.  The training shape (Yi-6B: B 2,
// S 2048, H 32 / KVH 4, d 128, causal) is 6.87e10 flops against 0.2 GB of
// q/k/v/out.  The trainer keeps TF32 off, since its parity contract is
// fp32, so a single TF32 product is not allowed; on the CUDA cores fp32 runs
// at 67 TFLOP/s at best (1.03 ms).  3xTF32 writes each fp32 operand as
// big + small, two TF32 values (big = x rounded to TF32 as cvt.rna.tf32
// rounds, small = x - big rounded the same way: together x to ~2^-22
// relative), and sums three
// tensor-core products, big.big + big.small + small.big, in fp32
// accumulators: only small.small (~2^-22 of a product) is dropped.  Three
// products at the TF32 rate (495 TFLOP/s) bound the shape at 0.417 ms.
//
// What the design does about it:
//   * one CTA of 4 warps owns kRows = 64 packed query rows of one KV head
//     (row r: token r / G, query head r % G), a warp 16 of them; QK^T and
//     PV run on mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, three
//     products each.  Where d is 256 the output columns split over 2 groups
//     of 4 warps, each computing the same scores (no thread holds more than
//     a 16 x 128 accumulator: 64 registers);
//   * Q, K and V stay fp32 in shared memory (cp.async 16-byte copies, K/V
//     in a 2-buffer ring of kKeys keys a round; keys past the range are
//     zero-filled by the copy, so a masked p = 0 never meets stale memory)
//     and are split when a fragment is loaded;
//   * ldmatrix does not transpose 32-bit elements, so fragments come from
//     plain 32-bit shared loads.  The k index of a fragment is permuted:
//     k = t of a quad's thread t stands for element 2t of the 8, k = t + 4
//     for element 2t + 1.  A and B of QK^T then come as float2 loads of
//     adjacent dims (row pad 8 floats: a half-warp's 16 float2 loads cover
//     32 distinct banks), the QK^T accumulator's (c0, c1, c2, c3) is PV's A
//     fragment (P[g][2t], P[g+8][2t], P[g][2t+1], P[g+8][2t+1]) without a
//     shuffle, and V's B fragment reads keys 2t and 2t + 1 of a column (row
//     pad 4 floats: the 32 loads of a warp hit 32 banks);
//   * the causal tiles differ 32-fold in their keys at the training shape;
//     the grid is one-dimensional and walks (KV head, batch row) fastest
//     and the query tiles from the last, so the longest tiles start first;
//   * the softmax is mma_tile.cuh's: scores scaled in fp32, soft-capped
//     c*tanh(s/c) before masking, log2 domain (exp2f), masked entries -inf
//     (p = 0), NEG_INF the running max's start, l clamped at 1e-20 (a row
//     that sees no key gets 0); a round that every row of the warp sees
//     whole skips the mask.
// The keys a round are a compile-time knob (REPRO_TF32_KEYS, 32 or 64 at
// d <= 128; d 256 takes 32, the only size that fits) so tile_study.py can
// build and time the other.
//
// Where the rows and keys live is gqa_tile.cuh's layout policy (type KV):
// start(b), causal(), q_row(b, kvh, r), kv_row(b, kvh, pos) and
// range(q_first, q_last, window, lo, hi) over contiguous positions.

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

// the cp.async helpers and the softmax's score of the bf16 tile
using mma_tile::cp_async16;
using mma_tile::cp_async_commit;
using mma_tile::cp_async_wait;
using mma_tile::kNegInf;
using mma_tile::log2_score;

constexpr int kRows = 64;     // packed query rows a CTA: 4 warps x 16
constexpr int kStages = 2;    // K/V buffers: the round computed, the next

template <int D>
struct Tile {
  static constexpr int kKeys = D <= 128 ? REPRO_TF32_KEYS : 32;
  static constexpr int kWarpCols = D < 128 ? D : 128;
  static constexpr int kColGroups = D / kWarpCols;
  static constexpr int kThreads = 128 * kColGroups;
  static constexpr int kLdK = D + 8;   // Q and K rows (floats)
  static constexpr int kLdV = D + 4;   // V rows
  static constexpr size_t kSmem =
      ((size_t)kRows * kLdK + (size_t)kStages * kKeys * (kLdK + kLdV)) * 4;
  // CTAs an SM the shared memory allows (2 at d 128 with 32 keys a round):
  // told to ptxas, so it does not trade spills for more
  static constexpr int kCtasPerSm = 2 * (kSmem + 1024) <= 228 * 1024 ? 2 : 1;
  static_assert(D % 32 == 0 && kKeys % 8 == 0 && D % kWarpCols == 0,
                "tile shape");
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

template <int D, typename KV>
__global__ void __launch_bounds__(Tile<D>::kThreads, Tile<D>::kCtasPerSm)
attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 KV layout, int SG, int G, int tiles, int ny, int nz,
                 int window, float softcap, float scale) {
  using Tl = Tile<D>;
  constexpr int NT = Tl::kThreads, LDK = Tl::kLdK, LDV = Tl::kLdV;
  constexpr int KN = Tl::kKeys, WC = Tl::kWarpCols;
  constexpr int CH = D / 4;   // 16-byte chunks a row

  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + kRows * LDK;              // [kStages][KN][LDK]
  float* Vs = Ks + kStages * KN * LDK;       // [kStages][KN][LDV]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  // (KV head, batch row) fastest, the query tiles from the last
  const int others = ny * nz;
  const int x = tiles - 1 - (int)(blockIdx.x / others);
  const int kvh = (int)(blockIdx.x % others) % ny;
  const int b = (int)(blockIdx.x % others) / ny;
  const int r0 = x * kRows;
  const int rows = min(kRows, SG - r0);
  const int start = layout.start(b);
  int lo, hi;
  layout.range(start + r0 / G, start + (r0 + rows - 1) / G, window, lo, hi);
  const int rounds = hi >= lo ? (hi - lo) / KN + 1 : 0;

  // this tile's queries; rows past `rows` are zero-filled and never written
  for (int i = tid; i < kRows * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 4;
    const bool ok = r < rows;
    cp_async16(Qs + r * LDK + c,
               q + (ok ? layout.q_row(b, kvh, r0 + r) : 0) * D + c, ok);
  }
  // round rd's K/V (positions lo + rd*KN ..) into stage rd % kStages
  auto issue = [&](int rd) {
    if (rd >= rounds) return;
    const int p0 = lo + rd * KN, st = rd % kStages;
    for (int i = tid; i < KN * CH; i += NT) {
      const int j = i / CH, c = (i % CH) * 4;
      const bool ok = p0 + j <= hi;
      const size_t row = ok ? layout.kv_row(b, kvh, p0 + j) : 0;
      cp_async16(Ks + (st * KN + j) * LDK + c, k + row * D + c, ok);
      cp_async16(Vs + (st * KN + j) * LDV + c, v + row * D + c, ok);
    }
  };
  issue(0);
  cp_async_commit();  // the queries and the first round

  const int rg = warp % 4, cg = warp / 4;   // row group, column group
  const int qr = rg * 16 + g;               // this thread's rows qr, qr + 8
  const int qp0 = start + (r0 + qr) / G, qp1 = start + (r0 + qr + 8) / G;
  const int q_warp = start + (r0 + rg * 16) / G;   // the warp's first query
  const bool causal = layout.causal();
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[WC / 8][4];
#pragma unroll
  for (int n = 0; n < WC / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int rd = 0; rd < rounds; ++rd) {
    const int st = rd % kStages;
    cp_async_wait<0>();
    // round rd has landed and every reader of the stage refilled below
    // (round rd - 1's) is done
    __syncthreads();
    issue(rd + 1);
    cp_async_commit();

    // S = Q K^T: 16 rows x KN keys a warp, fp32 by 3xTF32
    const float* Kst = Ks + st * KN * LDK;
    float s[KN / 8][4];
#pragma unroll
    for (int n = 0; n < KN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D; kk += 8) {
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
        const float2 y = *reinterpret_cast<const float2*>(
            Kst + (n * 8 + g) * LDK + kk + 2 * t4);
        uint32_t bb0, bs0, bb1, bs1;
        split(y.x, bb0, bs0);
        split(y.y, bb1, bs1);
        mma3(s[n], ab, as, bb0, bb1, bs0, bs1);
      }
    }

    // scale, soft-cap, mask (-inf), in log2 units; the online max.  A
    // round that every row of the warp sees whole (no window, every key
    // there and, when causal, at or before the warp's first query) takes
    // no mask
    const int p0 = lo + rd * KN;
    const bool full = p0 + KN - 1 <= hi;
    float mx[2] = {-INFINITY, -INFINITY};
    if (window <= 0 && full && (!causal || p0 + KN - 1 <= q_warp)) {
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
          const int p = p0 + n * 8 + 2 * t4 + (e & 1);
          const int qpos = e < 2 ? qp0 : qp1;
          const bool ok = p <= hi && (!causal || p <= qpos) &&
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
      for (int c = 0; c < WC / 8; ++c) {
        uint32_t bb0, bs0, bb1, bs1;
        split(vr[c * 8], bb0, bs0);
        split(vr[LDV + c * 8], bb1, bs1);
        mma3(acc[c], ab, as, bb0, bb1, bs0, bs1);
      }
    }
  }
  cp_async_wait<0>();  // a tile with no round still has the queries' group

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = qr + 8 * i;
    if (r >= rows) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-20f);
    float* o = out + layout.q_row(b, kvh, r0 + r) * D + cg * WC + 2 * t4;
#pragma unroll
    for (int c = 0; c < WC / 8; ++c)
      *reinterpret_cast<float2*>(o + c * 8) =
          make_float2(acc[c][2 * i] * inv, acc[c][2 * i + 1] * inv);
  }
}

template <int D, typename KV>
cudaError_t configure() {
  static bool done = false;  // once per instantiation
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      attention_kernel<D, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Tile<D>::kSmem);
  done = e == cudaSuccess;
  return e;
}

// Launch the tile over the ceil(SG / kRows) query tiles of each of the
// ny x nz (KV head, batch row) pairs, one CTA each, longest first.
template <int D, typename KV>
cudaError_t launch_attention(const void* q, const void* k, const void* v,
                             void* out, const KV& layout, int SG, int G,
                             int ny, int nz, int window, float softcap,
                             float scale, cudaStream_t stream) {
  using Tl = Tile<D>;
  cudaError_t e = configure<D, KV>();
  if (e != cudaSuccess) return e;
  const int tiles = (SG + kRows - 1) / kRows;
  const long long ctas = (long long)tiles * ny * nz;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  attention_kernel<D, KV><<<(unsigned)ctas, Tl::kThreads, Tl::kSmem,
                            stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), layout, SG, G,
      tiles, ny, nz, window, softcap, scale);
  return cudaGetLastError();
}

// out = {registers a thread, local (spill) bytes a thread, shared memory
// bytes a CTA, CTAs resident on one SM (as the runtime reports them),
// packed query rows a CTA} of the tile kernel
template <int D, typename KV>
cudaError_t resources(int* out) {
  using Tl = Tile<D>;
  cudaError_t e = configure<D, KV>();
  if (e != cudaSuccess) return e;
  auto kern = attention_kernel<D, KV>;
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
