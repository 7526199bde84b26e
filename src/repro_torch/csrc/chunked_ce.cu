// Fused output projection + cross-entropy for Hopper (sm_90a): K10, the loss
// of every training step (GLM-5 §2.4.1), without (tokens, V) logits in
// device memory.
//
// Replaces the TPU kernel of the JAX package:
//   K10  src/repro/kernels/chunked_ce/kernel.py  chunked_ce
//
// Contract (the Pallas kernel's): h (Tk, D), w (D, V) in float32 or
// bfloat16, targets (Tk,) int32, mask (Tk,) float32.  For token t the
// logits are z = h[t] . w (fp32), soft-capped c*tanh(z/c) when c > 0, and
// nll[t] = logsumexp(z) - z[targets[t]] (the target's logit taken after the
// cap; a target outside [0, V) contributes 0, as in the Pallas kernel).
// Out: per 128-token tile, loss[tile] = sum of mask * nll and
// count[tile] = sum of mask (the Pallas kernel's (nt, 1) outputs); the
// caller sums the tiles.
//
// What bounds it on this card: arithmetic.  The product is 2*Tk*D*V flops
// (2.1 TFLOP at the Yi-6B step: 4096 tokens, D 4096, V 64000) against
// (Tk + V) * D values read once; with TF32 off, fp32 runs on the CUDA
// cores at 67 TFLOP/s, so the bound is ~32 ms.
//
// What the design does about it:
//   * the Pallas kernel holds a whole (128, D) h tile and (D, 512) w tile
//     in 16 MiB of VMEM; at D = 4096 in fp32 that is 10 MB, far beyond the
//     227 KB a CTA has.  Here a CTA computes a 128-token x 128-vocab logits
//     tile in registers (8 x 8 a thread, 256 threads), walking D in steps
//     of 8 through shared memory (an SGEMM tile: each staged value feeds 8
//     FMAs of a thread), with the next step's loads in registers while
//     this step computes;
//   * the grid is (token tiles, vocab tiles), token tiles fastest, so the
//     CTAs in flight share their w tile through L2.  In place of the TPU's
//     sequential vocab axis, each CTA writes per-token partials (max, sum of
//     exp, target logit) for its vocab tile, and a second small kernel folds
//     them per token (the online logsumexp's combine) and sums each
//     128-token tile's mask * nll and mask;
//   * vocab ids past V and tokens past Tk load zeros and are masked out of
//     the max, the sum and the target pick-up.
// Not done yet (later work): tensor cores (mma/wgmma: with TF32 off, bf16
// inputs only), TMA, a larger logits tile.
//
// Interface: plain C, loaded with ctypes.  The entry point returns the
// cudaError_t of its launches (0 on success); it launches on the given
// stream, does not synchronise and allocates nothing: the caller passes
// 3 * ceil(V / 128) * Tk floats of scratch for the partials.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBT = 128;           // tokens a tile
constexpr int kBV = 128;           // vocab ids a tile
constexpr int kBK = 8;             // D a step
constexpr int kLdA = kBT + 4;      // As row stride: spreads a warp's stores
constexpr float kNegInf = -1e30f;  // the reference kernel's NEG_INF

__device__ inline float to_f(float x) { return x; }
__device__ inline float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// Logits tile (token tile blockIdx.x, vocab tile blockIdx.y) -> per-token
// partials of this vocab tile: max, sum of exp(z - max), target logit.
// Thread (ty, tx) = (tid / 16, tid % 16) owns tokens ty + 16*i and vocab
// ids tx + 16*j (i, j < 8): a token's 128 ids sit on 16 lanes of one warp.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_tile_kernel(const T* __restrict__ h, const T* __restrict__ w,
               const int* __restrict__ targets, float* __restrict__ part,
               int Tk, int D, int V, float softcap) {
  __shared__ float As[kBK * kLdA];  // h tile, transposed: [k][token]
  __shared__ float Bs[kBK * kBV];   // w tile: [k][vocab]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int t0 = blockIdx.x * kBT;
  const int v0 = blockIdx.y * kBV;

  // staging: 4 values of h and 4 of w a thread and step
  float ra[4], rb[4];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = tid + u * kThreads;
      const int r = e / kBK, kk = e % kBK;        // h: 8 consecutive of a row
      const int tok = t0 + r, kd = k0 + kk;
      ra[u] = (tok < Tk && kd < D) ? to_f(h[(size_t)tok * D + kd]) : 0.f;
      const int kw = k0 + e / kBV, c = v0 + e % kBV;  // w: a row of 128
      rb[u] = (kw < D && c < V) ? to_f(w[(size_t)kw * V + c]) : 0.f;
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = tid + u * kThreads;
      As[(e % kBK) * kLdA + e / kBK] = ra[u];
      Bs[e] = rb[u];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  fetch(0);
  for (int k0 = 0; k0 < D; k0 += kBK) {
    __syncthreads();                 // last step's readers are done
    stash();
    __syncthreads();
    if (k0 + kBK < D) fetch(k0 + kBK);  // lands during this step
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[kk * kLdA + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = Bs[kk * kBV + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
  }

  // per token: this tile's max, sum of exp and target logit, reduced over
  // the 16 lanes that hold the token's 128 vocab ids
  const size_t plane = (size_t)gridDim.y * Tk;   // partials of one kind
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int tok = t0 + ty + 16 * i;
    const int tgt = tok < Tk ? targets[tok] : -1;
    float z[8];
    float mx = kNegInf, tz = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = v0 + tx + 16 * j;
      float x = acc[i][j];
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      z[j] = c < V ? x : kNegInf;
      mx = fmaxf(mx, z[j]);
      if (c < V && c == tgt) tz += x;
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float l = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (v0 + tx + 16 * j < V) l += expf(z[j] - mx);
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      l += __shfl_xor_sync(0xffffffffu, l, o);
      tz += __shfl_xor_sync(0xffffffffu, tz, o);
    }
    if (tx == 0 && tok < Tk) {
      const size_t at = (size_t)blockIdx.y * Tk + tok;
      part[at] = mx;
      part[plane + at] = l;
      part[2 * plane + at] = tz;
    }
  }
}

// One thread per token: fold the n_vt vocab tiles' partials into
// logsumexp - target logit, then sum mask * nll and mask over the CTA's
// 128 tokens into loss[blockIdx.x] and count[blockIdx.x].
__global__ void __launch_bounds__(kBT)
ce_combine_kernel(const float* __restrict__ part,
                  const float* __restrict__ mask, float* __restrict__ loss,
                  float* __restrict__ count, int Tk, int n_vt) {
  __shared__ float red[2][kBT / 32];
  const int tok = blockIdx.x * kBT + threadIdx.x;
  float nll_m = 0.f, m_in = 0.f;
  if (tok < Tk) {
    const size_t plane = (size_t)n_vt * Tk;
    float M = kNegInf;
    for (int j = 0; j < n_vt; ++j) M = fmaxf(M, part[(size_t)j * Tk + tok]);
    float L = 0.f, tz = 0.f;
    for (int j = 0; j < n_vt; ++j) {
      const size_t at = (size_t)j * Tk + tok;
      L += part[plane + at] * expf(part[at] - M);
      tz += part[2 * plane + at];
    }
    m_in = mask[tok];
    nll_m = (M + logf(fmaxf(L, 1e-30f)) - tz) * m_in;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    nll_m += __shfl_xor_sync(0xffffffffu, nll_m, o);
    m_in += __shfl_xor_sync(0xffffffffu, m_in, o);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    red[0][warp] = nll_m;
    red[1][warp] = m_in;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f, c = 0.f;
    for (int i = 0; i < kBT / 32; ++i) {
      s += red[0][i];
      c += red[1][i];
    }
    loss[blockIdx.x] = s;
    count[blockIdx.x] = c;
  }
}

template <typename T>
cudaError_t run(const void* h, const void* w, const int* targets,
                const float* mask, float* part, float* loss, float* count,
                int Tk, int D, int V, float softcap, cudaStream_t s) {
  const int n_tt = (Tk + kBT - 1) / kBT, n_vt = (V + kBV - 1) / kBV;
  ce_tile_kernel<T><<<dim3(n_tt, n_vt), kThreads, 0, s>>>(
      static_cast<const T*>(h), static_cast<const T*>(w), targets, part, Tk,
      D, V, softcap);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ce_combine_kernel<<<n_tt, kBT, 0, s>>>(part, mask, loss, count, Tk, n_vt);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K10.  h (Tk, D), w (D, V): dtype 0 = float32, 1 = bfloat16; targets (Tk,)
// int32; mask (Tk,) float32; part: 3 * ceil(V/128) * Tk float32 scratch;
// loss, count: ceil(Tk/128) float32 each.
int chunked_ce(int dtype, const void* h, const void* w, const int* targets,
               const float* mask, float* part, float* loss, float* count,
               int Tk, int D, int V, float softcap, void* stream) {
  if (Tk <= 0 || D <= 0 || V <= 0 || (V + kBV - 1) / kBV > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run<float>(h, w, targets, mask, part, loss, count, Tk, D, V,
                           softcap, s);
  if (dtype == 1)
    return (int)run<__nv_bfloat16>(h, w, targets, mask, part, loss, count, Tk,
                                   D, V, softcap, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
