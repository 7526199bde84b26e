// The lightning-indexer SIMT tile shared by K5 and K6's fp32 route
// (csrc/paged_indexer.cu, keys through a block table) and K7 at head counts
// other than 16 and 32 (csrc/lightning_indexer.cu, contiguous keys).  K6's
// bf16 route and K7 at Hi 16 / 32 run indexer_mma.cuh's tensor-core body.
//
// For query row (b, i) and key position p:
//   out[b, i, p] = sum_h w[b, i, h] * (ReLU(q[b, i, h] . k[p]) * scale)
// in fp32, q (B, S, Hi, D) and the keys in the model's dtype, w float32.  A
// CTA of kThreads threads owns kThreads consecutive key positions (one a
// thread) and up to n_tok queries of one batch row: it stages the queries
// and head weights in shared memory as fp32 (read as broadcasts), a thread
// holds its key in registers as fp32 (16-byte vector loads) and scores it
// against every staged query; a query's output row is written by
// consecutive threads at consecutive positions.  A dead key (the keys
// policy says so) gets NEG_INF without a read; a tile whose first key is
// dead writes NEG_INF and reads nothing.
//
// Where the keys live is the Keys policy's:
//   len()        key positions of a row (the output's last dim; host and
//                device)
//   dead(b, p)   whether position p of row b is dead
//   slot(b, p)   row index (in units of D) of position p's key

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include "vec.cuh"

namespace {

constexpr int kThreads = 128;      // key positions per CTA, one a thread
constexpr int kMaxTok = 8;         // queries per CTA
constexpr int kQFloats = 8192;     // staged fp32 queries a CTA (32 KB)
constexpr float kNegInf = -1e30f;  // the reference kernels' NEG_INF

// queries a CTA takes: as many as kQFloats of staged queries hold, at most
// kMaxTok (decode: the one token)
inline int tokens_per_cta(int S, int heads, int D) {
  int n = kQFloats / (heads * D);
  n = n < 1 ? 1 : (n > kMaxTok ? kMaxTok : n);
  return n < S ? n : S;
}

inline size_t smem_bytes(int n_tok, int heads, int D) {
  return ((size_t)n_tok * heads * D + (size_t)n_tok * heads) * sizeof(float);
}

template <typename T, int D, typename Keys>
__global__ void __launch_bounds__(kThreads)
indexer_tile_kernel(const T* __restrict__ q, const float* __restrict__ w,
                    const T* __restrict__ k, float* __restrict__ out,
                    Keys keys, int S, int Hi, int n_tok, float scale) {
  constexpr int VN = Vec<T>::N;
  static_assert(D % VN == 0 && D % 4 == 0, "vector width");

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);    // n_tok x Hi x D
  float* Ws = Qs + (size_t)n_tok * Hi * D;        // n_tok x Hi

  const int tid = threadIdx.x;
  const int T_len = keys.len();                   // key positions of a row
  const int p0 = blockIdx.x * kThreads;
  const int p = p0 + tid;
  const int i0 = blockIdx.y * n_tok;
  const int b = blockIdx.z;
  const int toks = min(n_tok, S - i0);
  float* o = out + ((size_t)b * S + i0) * T_len + p;

  // the tile's first key is dead: all of it is
  if (keys.dead(b, p0)) {
    if (p < T_len)
      for (int i = 0; i < toks; ++i) o[(size_t)i * T_len] = kNegInf;
    return;
  }

  // stage the tile's queries and head weights as fp32
  const int RD = Hi * D;                          // query values of a token
  const size_t row0 = ((size_t)b * S + i0) * Hi;  // first packed query row
  const T* qsrc = q + row0 * D;
  for (int e = tid * VN; e < toks * RD; e += kThreads * VN) {
    float tmp[VN];
    Vec<T>::convert(ld16(qsrc + e), tmp);
#pragma unroll
    for (int u = 0; u < VN; ++u) Qs[e + u] = tmp[u];
  }
  for (int e = tid; e < toks * Hi; e += kThreads) Ws[e] = w[row0 + e];
  __syncthreads();

  if (p >= T_len) return;
  if (keys.dead(b, p)) {                          // a dead key of the tile
    for (int i = 0; i < toks; ++i) o[(size_t)i * T_len] = kNegInf;
    return;
  }
  // this thread's key, in registers as fp32
  const T* ksrc = k + keys.slot(b, p) * D;
  float kr[D];
#pragma unroll
  for (int v = 0; v < D / VN; ++v)
    Vec<T>::convert(ld16(ksrc + v * VN), kr + v * VN);

  for (int i = 0; i < toks; ++i) {
    const float* qi = Qs + (size_t)i * RD;
    const float* wi = Ws + i * Hi;
    float acc = 0.f;
    for (int h = 0; h < Hi; ++h) {
      const float4* qh = reinterpret_cast<const float4*>(qi + h * D);
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < D / 4; ++e) {
        const float4 x = qh[e];
        dot = fmaf(x.x, kr[4 * e], dot);
        dot = fmaf(x.y, kr[4 * e + 1], dot);
        dot = fmaf(x.z, kr[4 * e + 2], dot);
        dot = fmaf(x.w, kr[4 * e + 3], dot);
      }
      acc = fmaf(wi[h], fmaxf(dot, 0.f) * scale, acc);
    }
    o[(size_t)i * T_len] = acc;
  }
}

// Launch the tile kernel over (ceil(len / kThreads), ceil(S / n_tok), B)
// CTAs on `stream`.
template <typename T, int D, typename Keys>
cudaError_t launch_indexer_tiles(const void* q, const float* w, const void* k,
                                 float* out, const Keys& keys, int B, int S,
                                 int Hi, float scale, cudaStream_t stream) {
  const int n_tok = tokens_per_cta(S, Hi, D);
  dim3 grid((keys.len() + kThreads - 1) / kThreads, (S + n_tok - 1) / n_tok,
            B);
  indexer_tile_kernel<T, D, Keys><<<grid, kThreads,
                                    smem_bytes(n_tok, Hi, D), stream>>>(
      static_cast<const T*>(q), w, static_cast<const T*>(k), out, keys, S,
      Hi, n_tok, scale);
  return cudaGetLastError();
}

}  // namespace
