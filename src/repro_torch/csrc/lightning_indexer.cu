// DSA lightning-indexer scores for Hopper (sm_90a): K7, the contiguous form
// the training path and the block selector's serve spans run (no cache, no
// block table).
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
// serve every query of the CTA.  At the Yi-6B + DSA training chunk (a
// 256-query chunk against 4096 keys, fp32, TF32 off in the trainer) that is
// 2.2 GFLOP against 4.2 MB of fp32 output: 0.033 ms on the CUDA cores'
// 67 TFLOP/s, 0.013 ms as three TF32 products at 495.  The block selector's
// serve span (256 queries against the ~6.5 K-position gathered view, bf16)
// is 3.5 GFLOP: 0.0035 ms at the bf16 rate.
//
// What the design does: the Pallas grid is (B, nQ, nK) with a 128 x 128
// score tile on the MXU; here Hi 8, 16 and 32 (zamba2 + DSA's 8 x 64,
// Yi-6B's 16 x 64, GLM-5's 32 x 128) run the tensor-core body of
// indexer_mma.cuh, K6's, with the keys addressed directly (DenseKeys: row
// b*T + p, none dead, a ragged T zero-filled by the copy and never
// stored); at 8 heads a token's heads are one n-tile of the product, so a
// key fragment serves the warp's tokens and no more:
//   * bf16 on mma.sync m16n8k16, the body K6 runs;
//   * fp32 by 3xTF32 on mma.sync m16n8k8 (big.big + big.small +
//     small.big, fp32-level error: the trainer's parity contract is fp32
//     and a single TF32 product misses it), the queries split once as they
//     are staged, the keys as their fragments load.
// Any other head count runs indexer_tile.cuh's SIMT tile (K5's): a CTA of
// 128 threads owns 128 consecutive keys (one a thread, in registers as
// fp32) and up to kMaxTok queries staged in shared memory.  Not done yet
// (later work): wgmma, TMA.
//
// Interface: plain C, loaded with ctypes.  The entry points return the
// cudaError_t of their launch (0 on success); they launch on the given
// stream, do not synchronise and allocate nothing.

#include <cuda_runtime.h>
#include <stddef.h>

#include "indexer_mma.cuh"
#include "indexer_tile.cuh"

namespace {

// K7's keys: k (B, T, Di) contiguous, every position live.
struct DenseKeys {
  static constexpr bool kTable = false;
  int T, S;
  __host__ __device__ int len() const { return T; }
  __host__ __device__ int tokens() const { return S; }
  __device__ bool dead(int, int) const { return false; }
  __device__ size_t slot(int b, int p) const { return (size_t)b * T + p; }
  __device__ int live_end(int) const { return T; }
  __device__ size_t row(int b, int p, int, const int*) const {
    return slot(b, p);
  }
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
  return launch_indexer_tiles<T, D>(a.q, a.w, a.k, a.out,
                                    DenseKeys{a.T, a.S}, a.B, a.S, a.Hi,
                                    a.scale, stream);
}

template <typename T>
cudaError_t launch_dim(int D, const Args& a, cudaStream_t s) {
  if (indexer_mma::takes(a.Hi, D))
    return indexer_mma::by_shape(a.Hi, D, [&](auto hi, auto di) {
      return indexer_mma::launch<T, decltype(hi)::value, decltype(di)::value>(
          a.q, a.w, a.k, a.out, DenseKeys{a.T, a.S}, a.B, a.scale, s);
    });
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

// Resources of K7's tensor-core body for `dtype` (0: fp32 by 3xTF32, 1:
// bf16), `heads` and `index_dim` (launches nothing; cudaErrorInvalidValue
// where K7 runs the SIMT tile): out[5] = registers a thread, spill bytes a
// thread, shared memory bytes a CTA, CTAs resident on one SM, tokens a CTA.
int lightning_indexer_resources(int dtype, int heads, int index_dim,
                                int* out) {
  if (!indexer_mma::takes(heads, index_dim) ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  return (int)indexer_mma::by_shape(heads, index_dim, [&](auto hi, auto di) {
    constexpr int HI = decltype(hi)::value, DI = decltype(di)::value;
    return dtype == 0
        ? indexer_mma::resources<float, HI, DI, DenseKeys>(out)
        : indexer_mma::resources<__nv_bfloat16, HI, DI, DenseKeys>(out);
  });
}

}  // extern "C"
