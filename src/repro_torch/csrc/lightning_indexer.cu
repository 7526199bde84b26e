// DSA lightning-indexer scores for Hopper (sm_90a): K7, the contiguous form
// the training path runs (no cache, no block table).
//
// Replaces the TPU kernel of the JAX package:
//   K7  src/repro/kernels/lightning_indexer/kernel.py  lightning_indexer
//
// Contract (the Pallas kernel's): q (B, S, Hi*Di) in the model's dtype,
// w (B, S, Hi) float32 (the softmaxed head weights), k (B, T, Di) in the
// model's dtype; for every query s and key t
//   out[b, s, t] = sum_h w[b, s, h] * (ReLU(q[b, s, h] . k[b, t]) * scale)
// (scale = Di^-1/2, passed in), float32, every (s, t) written: no mask, the
// caller applies the causal mask, as the reference does.  The products
// accumulate in fp32.
//
// What bounds it on this card: arithmetic.  A (query, key) pair costs
// Hi*(2*Di + 2) flops (2080 at Yi-6B's 16 x 64) and each key's Di values
// serve every query of the CTA; at the Yi-6B + DSA training shape (a
// 256-query chunk against 4096 keys) that is 2.2 GFLOP against 4.2 MB of
// fp32 output, and in fp32 the CUDA cores' 67 TFLOP/s set the bound.
//
// What the design does (indexer_tile.cuh, K6's body, with contiguous keys
// and none dead: DenseKeys below):
//   * the Pallas grid is (B, nQ, nK) with a 128 x 128 score tile on the
//     MXU; here a CTA of 128 threads owns 128 consecutive keys (one a
//     thread) and up to kMaxTok queries, so a 256 x 4096 chunk is 32 x 32
//     CTAs a batch row;
//   * the CTA stages its queries and weights in shared memory as fp32
//     (Hi x Di x 4 = 4 KB a query at 16 x 64), read as broadcasts;
//   * a thread holds its key's Di values in registers as fp32 (16-byte
//     vector loads) and reuses them for every query row of the tile;
//   * a query's output row is written by consecutive threads at
//     consecutive keys: coalesced.
// Not done yet (later work): tensor cores (the (S*Hi) x Di by Di x keys
// product is an mma tile), staging keys through shared memory, TMA.
//
// Interface: plain C, loaded with ctypes.  The entry point returns the
// cudaError_t of its launch (0 on success); it launches on the given stream,
// does not synchronise and allocates nothing.

#include <cuda_runtime.h>
#include <stddef.h>

#include "indexer_tile.cuh"

namespace {

// K7's keys: k (B, T, Di) contiguous, every position live.
struct DenseKeys {
  int T;
  __host__ __device__ int len() const { return T; }
  __device__ bool dead(int, int) const { return false; }
  __device__ size_t slot(int b, int p) const { return (size_t)b * T + p; }
};

struct Args {
  const void* q;
  const float* w;
  const void* k;
  float* out;
  int B, S, T, Hi;
  float scale;
};

template <typename T, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  return launch_indexer_tiles<T, D>(a.q, a.w, a.k, a.out, DenseKeys{a.T},
                                    a.B, a.S, a.Hi, a.scale, stream);
}

template <typename T>
cudaError_t launch_dim(int D, const Args& a, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(a, s);
    case 32: return launch<T, 32>(a, s);
    case 64: return launch<T, 64>(a, s);
    case 128: return launch<T, 128>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// K7.  q (B, S, Hi*Di); w (B, S, Hi) float32; k (B, T, Di); out (B, S, T)
// float32.  dtype of q and k: 0 = float32, 1 = bfloat16.
int lightning_indexer(int dtype, int index_dim, const void* q, const float* w,
                      const void* k, float* out, int B, int S, int T,
                      int heads, float scale, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || heads <= 0
      || heads * index_dim > kQFloats)
    return (int)cudaErrorInvalidValue;
  Args a{q, w, k, out, B, S, T, heads, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_dim<float>(index_dim, a, s);
  if (dtype == 1) return (int)launch_dim<__nv_bfloat16>(index_dim, a, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
