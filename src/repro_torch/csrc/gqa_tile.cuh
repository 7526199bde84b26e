// The SIMT attention tile of K2's fp32 span prefill (csrc/paged_attention.cu,
// K/V through a block table: the exact parity route).  Its only user: bf16
// spans run mma_tile.cuh's tensor-core tile, as do K8's and K9's bf16
// routes, and K8's and K9's fp32 routes run tf32_tile.cuh.
//
// One CTA of kThreads threads owns ROWS packed query rows of one KV head of
// one batch row: packed row r is group query (head) r % G of token r / G,
// at position start + r / G.  It walks the tile's live keys in rounds of
// kTokens positions, staged in shared memory as fp32 (every load of a
// round issued before any is used, the next round's in flight where
// registers allow), scores them against every row (scaled, soft-capped
// c*tanh(s/c), masked causally and by the window), folds them with an
// fp32 online softmax (a warp per row; masked entries count as NEG_INF in
// the max and contribute p = 0) and accumulates P @ V in registers, each
// thread owning fixed columns (D a multiple of 16; where D does not divide
// the CTA's threads, d 80, the threads past the last whole column group
// own none).  The output divides by max(l, 1e-20), so a
// row that sees no key gets 0.  A round past the live range stages zeros,
// so a masked p = 0 never meets stale shared memory.
//
// What bounds it: fp32 spans (K2's fp32 route) are bound by the CUDA
// cores' fp32 rate (67 TFLOP/s), the rate an exact fp32 product (TF32 off)
// has.
//
// Where the rows and keys live is the layout policy's (type KV):
//   start(b)            position of batch row b's token 0
//   causal()            whether keys after a query's position are masked
//   q_row(b, kvh, r)    row index (in units of D) of packed query row r
//   kv_row(b, kvh, pos) row index (in units of D) of key / value position pos
//   range(q_first, q_last, window, lo, hi)
//                       the keys the tile reads: lo .. hi inclusive

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "vec.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTokens = 64;        // K/V positions staged per round
constexpr float kNegInf = -1e30f;  // the reference kernels' NEG_INF

// Shared-memory row strides (floats).  +4 keeps 16-byte alignment for the
// float4 reads and spreads a quarter-warp's rows over distinct banks.
template <int D>
constexpr int kLdQK = D + 4;
constexpr int kLdP = kTokens + 4;

template <int D, int ROWS>
constexpr size_t smem_floats() {
  return (size_t)ROWS * kLdQK<D>      // Qs
         + (size_t)kTokens * kLdQK<D>  // Ks
         + (size_t)kTokens * D           // Vs
         + (size_t)ROWS * kLdP           // Ps
         + 3 * (size_t)ROWS;             // running max, sum, rescale
}

template <int D, int ROWS, typename KV>
__global__ void __launch_bounds__(kThreads)
gqa_tile_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ out,
                KV layout, int SG, int G, int window, float softcap,
                float scale) {
  static_assert(D % 16 == 0 && ROWS % 4 == 0, "tile shape");
  static_assert(D < kThreads || D % kThreads == 0, "column split");
  constexpr int LD = kLdQK<D>;
  constexpr int VN = Vec<float>::N;
  constexpr int CPT = D >= kThreads ? D / kThreads : 1;  // columns per thread
  constexpr int RG = D >= kThreads ? 1 : kThreads / D;   // row groups
  constexpr int RPT = ROWS / RG;                         // rows per thread
  // threads that own output columns: all but the kThreads % D left over
  // where D does not divide kThreads (d 80: 80 of 128), which take their
  // part in staging, scores and the softmax only
  constexpr int kPvThreads = D >= kThreads ? kThreads : RG * D;
  static_assert(ROWS % RG == 0, "row groups");
  constexpr int VROW = D / VN;            // 16-byte vectors per K/V row
  static_assert(kTokens * VROW % kThreads == 0, "staging split");
  constexpr int NV = kTokens * VROW / kThreads;  // per thread and tensor
  // the next round's K/V wait in registers while this round computes,
  // where the accumulator leaves room
  constexpr bool kPrefetch = NV * 8 + RPT * CPT <= 128;

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + ROWS * LD;
  float* Vs = Ks + kTokens * LD;
  float* Ps = Vs + kTokens * D;
  float* Ms = Ps + ROWS * kLdP;
  float* Ls = Ms + ROWS;
  float* As = Ls + ROWS;

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * ROWS;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int rows = min(ROWS, SG - r0);
  const int start = layout.start(b);
  const int q_first = start + r0 / G;
  const int q_last = start + (r0 + rows - 1) / G;

  // stage this tile's query rows; rows past `rows` stay unset and their
  // results are never written
  for (int i = tid; i < rows * (D / VN); i += kThreads) {
    const int r = i / (D / VN), e = (i % (D / VN)) * VN;
    float tmp[VN];
    Vec<float>::convert(ld16(q + layout.q_row(b, kvh, r0 + r) * D + e), tmp);
#pragma unroll
    for (int u = 0; u < VN; ++u) Qs[r * LD + e + u] = tmp[u];
  }
  for (int r = tid; r < ROWS; r += kThreads) {
    Ms[r] = kNegInf;
    Ls[r] = 0.f;
  }

  const int col0 = tid % (D < kThreads ? D : kThreads);
  const int rg = D >= kThreads ? 0 : tid / D;
  const bool pv = kPvThreads == kThreads || tid < kPvThreads;
  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  // live range of the tile: from the first key in its window to its last
  // query's key (the whole range when not causal)
  int lo, hi;
  layout.range(q_first, q_last, window, lo, hi);

  // every K/V load of the round at c is issued before any is used, so a
  // thread has 2*NV 16-byte loads in flight; past hi it stages zeros, so
  // the p = 0 padding of a short round never meets stale shared memory
  uint4 kraw[NV], vraw[NV];
  auto fetch = [&](int c) {
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int i = tid + u * kThreads;
      const int pos = c + i / VROW;
      if (pos <= hi) {
        const size_t off = layout.kv_row(b, kvh, pos) * D + (i % VROW) * VN;
        kraw[u] = ld16(k + off);
        vraw[u] = ld16(v + off);
      } else {
        kraw[u] = vraw[u] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int i = tid + u * kThreads;
      const int t = i / VROW, e = (i % VROW) * VN;
      float kt[VN], vt[VN];
      Vec<float>::convert(kraw[u], kt);
      Vec<float>::convert(vraw[u], vt);
      float4* kd = reinterpret_cast<float4*>(Ks + t * LD + e);
      float4* vd = reinterpret_cast<float4*>(Vs + t * D + e);
#pragma unroll
      for (int w = 0; w < VN / 4; ++w) {
        kd[w] = make_float4(kt[4 * w], kt[4 * w + 1], kt[4 * w + 2],
                            kt[4 * w + 3]);
        vd[w] = make_float4(vt[4 * w], vt[4 * w + 1], vt[4 * w + 2],
                            vt[4 * w + 3]);
      }
    }
  };

  if constexpr (kPrefetch) {
    if (lo <= hi) fetch(lo);
  }
  for (int c0 = lo; c0 <= hi; c0 += kTokens) {
    const int n = min(kTokens, hi - c0 + 1);
    if constexpr (!kPrefetch) fetch(c0);
    __syncthreads();  // last round's readers of Ks/Vs/Ps are done
    stash();
    if constexpr (kPrefetch) {
      if (c0 + kTokens <= hi) fetch(c0 + kTokens);  // lands during compute
    }
    __syncthreads();

    // scores: each thread takes 4 consecutive rows x 1 position so one
    // K read serves four query rows; -inf marks a masked entry
    for (int i = tid; i < (ROWS / 4) * kTokens; i += kThreads) {
      const int rq = (i / kTokens) * 4, t = i % kTokens;
      if (rq >= rows) break;  // i only grows along rq
      float dot[4] = {0.f, 0.f, 0.f, 0.f};
      if (t < n) {
        const float4* kr = reinterpret_cast<const float4*>(Ks + t * LD);
#pragma unroll 8
        for (int e4 = 0; e4 < D / 4; ++e4) {
          const float4 kv = kr[e4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float4 qv =
                reinterpret_cast<const float4*>(Qs + (rq + u) * LD)[e4];
            dot[u] = fmaf(qv.x, kv.x, dot[u]);
            dot[u] = fmaf(qv.y, kv.y, dot[u]);
            dot[u] = fmaf(qv.z, kv.z, dot[u]);
            dot[u] = fmaf(qv.w, kv.w, dot[u]);
          }
        }
      }
      const int kp = c0 + t;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int qp = start + (r0 + rq + u) / G;
        const bool ok = t < n && (!layout.causal() || kp <= qp) &&
                        (window <= 0 || qp - kp < window);
        float s = dot[u] * scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        Ps[(rq + u) * kLdP + t] = ok ? s : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax, one warp per row (the reference's update: masked
    // entries, positions past n included, count as NEG_INF in the max and
    // contribute p = 0)
    {
      constexpr int kPerLane = kTokens / 32;
      const int warp = tid / 32, lane = tid % 32;
      for (int r = warp; r < rows; r += kThreads / 32) {
        float* pr = Ps + r * kLdP;
        float sv[kPerLane];
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) {
          sv[j] = pr[lane + 32 * j];
          mx = fmaxf(mx, sv[j]);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_prev = Ms[r];
        const float m_new = fmaxf(m_prev, mx);
        float l = 0.f;
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) {
          const float p = sv[j] == -INFINITY ? 0.f : expf(sv[j] - m_new);
          pr[lane + 32 * j] = p;
          l += p;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          l += __shfl_xor_sync(0xffffffffu, l, o);
        if (lane == 0) {
          const float alpha = expf(m_prev - m_new);
          Ls[r] = Ls[r] * alpha + l;
          Ms[r] = m_new;
          As[r] = alpha;
        }
      }
    }
    __syncthreads();

    // acc = acc * alpha + P @ V over this round's positions
    if (!pv) continue;   // no barrier below before the next round's
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rg + i * RG;
      const float alpha = r < rows ? As[r] : 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] *= alpha;
    }
    for (int t4 = 0; t4 < n; t4 += 4) {
      float v[4][CPT];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int j = 0; j < CPT; ++j)
          v[u][j] = Vs[(t4 + u) * D + col0 + j * kThreads];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float4 p =
            reinterpret_cast<const float4*>(Ps + (rg + i * RG) * kLdP)[t4 / 4];
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
  for (int i = 0; i < RPT; ++i) {
    const int r = rg + i * RG;
    if (pv && r < rows) {
      const float l = fmaxf(Ls[r], 1e-20f);
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        store_out(out + layout.q_row(b, kvh, r0 + r) * D + col0
                      + j * kThreads, acc[i][j] / l);
    }
  }
}

// Launch the tile kernel over (ceil(SG / ROWS), KVH, B) CTAs on `stream`.
template <int D, int ROWS, typename KV>
cudaError_t launch_gqa_tiles(const void* q, const void* k, const void* v,
                             void* out, const KV& layout, int B, int KVH,
                             int SG, int G, int window, float softcap,
                             float scale,
                             cudaStream_t stream) {
  constexpr size_t smem = smem_floats<D, ROWS>() * sizeof(float);
  auto kern = gqa_tile_kernel<D, ROWS, KV>;
  static bool configured = false;  // once per instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid((SG + ROWS - 1) / ROWS, KVH, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), layout, SG, G,
      window, softcap, scale);
  return cudaGetLastError();
}

}  // namespace
