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
// an fp32 online softmax; the final division clamps l at 1e-20 so a trash
// row (length 0) still gives a finite output.
//
// What bounds it on this card: the live K/V bytes.  Decode reads
// (seq_len + 1) * KVH * d * 2 values per row and does 4 flops per value and
// group query, far below the ~295 flop/byte ridge of an H100 in bf16; span
// prefill at S*G rows per kv-head does S*G times more work per byte and,
// at the chunk sizes the engine uses, is bound by its arithmetic.
//
// What the design does about it:
//   * one CTA per (query-row tile, kv-head, batch row) walks only that
//     tile's live blocks itself: it loads its own table entries and start,
//     begins at the first in-window block and stops at the block of its
//     last query position (causal early exit per tile), so traffic is
//     O(live tokens) and nothing is gathered into a padded view;
//   * kTokens positions of K and V are staged in shared memory as fp32 and
//     scored against every query row of the tile, so each K/V byte is read
//     from device memory once per tile; all of a round's loads are issued
//     before any is used and, where registers allow (bf16, d <= 128), the
//     next round's loads are in flight while this round computes;
//   * the Pallas prefill kernel keeps the whole packed span resident (4 MB
//     of fp32 accumulator at S = 1024, G = 8, d = 128); here the query rows
//     are tiled (64 rows per CTA, 32 at d = 256) and the accumulator lives in
//     registers, each thread owning fixed columns of the tile.
// Not done yet (later work): split-KV with a combine pass (decode at B = 8
// fills only B * KVH CTAs of 132 SMs), tensor cores (wgmma), TMA.
//
// Interface: plain C, loaded with ctypes.  Each entry point returns the
// cudaError_t of its launch (0 on success); it launches on the given stream,
// does not synchronise and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTokens = 64;        // K/V positions staged per round
constexpr int kRowsDecode = 8;     // query rows per CTA for K1 (G <= 8: one tile)
constexpr float kNegInf = -1e30f;  // the reference kernels' NEG_INF

// 16-byte vectors: N elements of T, loaded raw and converted to fp32
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void convert(const uint4& v, float* o) {
    const float* f = reinterpret_cast<const float*>(&v);
    o[0] = f[0]; o[1] = f[1]; o[2] = f[2]; o[3] = f[3];
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void convert(const uint4& v, float* o) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};

__device__ inline uint4 ld16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ inline void store_out(float* p, float x) { *p = x; }
__device__ inline void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

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

template <typename T, int D, int BS, int ROWS>
__global__ void __launch_bounds__(kThreads)
paged_gqa_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                 const T* __restrict__ v_pool, const int* __restrict__ tables,
                 const int* __restrict__ starts, T* __restrict__ out, int KVH,
                 int SG, int G, int mb, int window, float softcap,
                 float scale) {
  static_assert(D % 32 == 0 && ROWS % 4 == 0, "tile shape");
  constexpr int LD = kLdQK<D>;
  constexpr int VN = Vec<T>::N;
  constexpr int CPT = D >= kThreads ? D / kThreads : 1;  // columns per thread
  constexpr int RG = D >= kThreads ? 1 : kThreads / D;   // row groups
  constexpr int RPT = ROWS / RG;                         // rows per thread
  constexpr int VROW = D / VN;            // 16-byte vectors per K/V row
  static_assert(kTokens * VROW % kThreads == 0, "staging split");
  constexpr int NV = kTokens * VROW / kThreads;  // per thread and tensor
  // the next round's K/V wait in registers while this round computes,
  // where the accumulator leaves room (bf16 at d <= 128)
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
  const int start = starts[b];
  const int q_first = start + r0 / G;
  const int q_last = start + (r0 + rows - 1) / G;
  const int* table = tables + (size_t)b * mb;
  const size_t row0 = ((size_t)b * KVH + kvh) * SG + r0;  // packed row index

  // stage this tile's query rows; rows past `rows` stay unset and their
  // results are never written
  for (int i = tid; i < rows * (D / VN); i += kThreads) {
    const int r = i / (D / VN), e = (i % (D / VN)) * VN;
    float tmp[VN];
    Vec<T>::convert(ld16(q + (row0 + r) * D + e), tmp);
#pragma unroll
    for (int u = 0; u < VN; ++u) Qs[r * LD + e + u] = tmp[u];
  }
  for (int r = tid; r < ROWS; r += kThreads) {
    Ms[r] = kNegInf;
    Ls[r] = 0.f;
  }

  const int col0 = tid % (D < kThreads ? D : kThreads);
  const int rg = D >= kThreads ? 0 : tid / D;
  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  // live range of the tile: first in-window block .. block of q_last
  int lo = window > 0 ? max(q_first - window + 1, 0) : 0;
  lo = (lo / BS) * BS;
  const int hi = min(q_last, mb * BS - 1);

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
        const size_t off = (((size_t)table[pos / BS] * BS + pos % BS) * KVH
                            + kvh) * D + (i % VROW) * VN;
        kraw[u] = ld16(k_pool + off);
        vraw[u] = ld16(v_pool + off);
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
      Vec<T>::convert(kraw[u], kt);
      Vec<T>::convert(vraw[u], vt);
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
        const bool ok = t < n && kp <= qp && (window <= 0 || qp - kp < window);
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
    if (r < rows) {
      const float l = fmaxf(Ls[r], 1e-20f);
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        store_out(out + (row0 + r) * D + col0 + j * kThreads, acc[i][j] / l);
    }
  }
}

struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const int* tables;
  const int* starts;
  void* out;
  int B, KVH, SG, G, mb, window;
  float softcap, scale;
};

template <typename T, int D, int BS, int ROWS>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<D, ROWS>() * sizeof(float);
  auto kern = paged_gqa_kernel<T, D, BS, ROWS>;
  static bool configured = false;  // once per instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid((a.SG + ROWS - 1) / ROWS, a.KVH, a.B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k_pool),
      static_cast<const T*>(a.v_pool), a.tables, a.starts,
      static_cast<T*>(a.out), a.KVH, a.SG, a.G, a.mb, a.window, a.softcap,
      a.scale);
  return cudaGetLastError();
}

template <typename T, int D, int ROWS>
cudaError_t by_block(int bs, const Args& a, cudaStream_t s) {
  switch (bs) {
    case 8: return launch<T, D, 8, ROWS>(a, s);
    case 16: return launch<T, D, 16, ROWS>(a, s);
    case 32: return launch<T, D, 32, ROWS>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

// prefill tiles: 64 rows at d <= 128, 32 at d = 256 (register budget of
// the per-thread accumulator, shared memory of the staged tiles)
template <typename T>
cudaError_t dispatch(bool decode, int d, int bs, const Args& a,
                     cudaStream_t s) {
  switch (d) {
    case 64:
      return decode ? by_block<T, 64, kRowsDecode>(bs, a, s)
                    : by_block<T, 64, 64>(bs, a, s);
    case 128:
      return decode ? by_block<T, 128, kRowsDecode>(bs, a, s)
                    : by_block<T, 128, 64>(bs, a, s);
    case 256:
      return decode ? by_block<T, 256, kRowsDecode>(bs, a, s)
                    : by_block<T, 256, 32>(bs, a, s);
    default: return cudaErrorInvalidValue;
  }
}

int run(bool decode, int dtype, int d, int bs, const Args& a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(decode, d, bs, a, s);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(decode, d, bs, a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K1.  q (B, KVH, G, d); pools (nb, bs, KVH, d); tables (B, mb) int32;
// seq_lens (B,) int32 (the query's position); out (B, KVH, G, d).
// dtype: 0 = float32, 1 = bfloat16.
int paged_decode_gqa(int dtype, int head_dim, int block_size, const void* q,
                     const void* k_pool, const void* v_pool,
                     const int* tables, const int* seq_lens, void* out, int B,
                     int KVH, int G, int mb, int window, float softcap,
                     float scale, void* stream) {
  Args a{q, k_pool, v_pool, tables, seq_lens, out, B, KVH, G, G, mb,
         window, softcap, scale};
  return run(true, dtype, head_dim, block_size, a, stream);
}

// K2.  q (B, KVH, S*G, d) packed rows i*G + g; starts (B,) int32 (position
// of span token 0); out like q.
int paged_prefill_gqa(int dtype, int head_dim, int block_size, const void* q,
                      const void* k_pool, const void* v_pool,
                      const int* tables, const int* starts, void* out, int B,
                      int KVH, int SG, int G, int mb, int window,
                      float softcap, float scale, void* stream) {
  Args a{q, k_pool, v_pool, tables, starts, out, B, KVH, SG, G, mb,
         window, softcap, scale};
  return run(false, dtype, head_dim, block_size, a, stream);
}

}  // extern "C"
