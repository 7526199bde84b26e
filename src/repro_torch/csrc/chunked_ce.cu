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
// (2.15 TFLOP at the Yi-6B step: 4096 tokens, D 4096, V 64000) against
// (Tk + V) * D values read once.  The trainer keeps TF32 off, since its
// parity contract is fp32, so a single TF32 product is not allowed: on the
// CUDA cores fp32 runs at 67 TFLOP/s at best (32.05 ms).  3xTF32 (as K9's
// tile, csrc/tf32_tile.cuh, whose helpers this file shares) writes each
// fp32 operand as big + small, two TF32 values, and sums the three
// tensor-core products big.big + big.small + small.big in fp32
// accumulators: fp32-level error, three products at the TF32 rate (494.7
// TFLOP/s) bound the step's shape at 13.02 ms (V 65024: 13.23 ms).
//
// What the design does about it (fp32, tf32_tile_kernel below):
//   * the Pallas kernel holds a whole (128, D) h tile and (D, 512) w tile
//     in 16 MiB of VMEM; at D = 4096 in fp32 that is 10 MB, far beyond the
//     227 KB a CTA has.  Here a CTA of 8 warps computes a 128-token x
//     128-vocab logits tile in registers, a warp 64 x 32 of it (16 x 8 x 8
//     mma.sync tiles, m16n8k8 TF32, three products each); D is walked 32 at
//     a time through a ring of kStages shared-memory stages filled by
//     cp.async (16-byte copies; 4-byte ones where V or D is not a multiple
//     of 4; tokens past Tk, ids past V and dims past D zero-filled by the
//     copy itself);
//   * fragments come from plain 32-bit shared loads under tf32_tile.cuh's
//     permuted k index (k = t of a quad's thread t is element 2t of the
//     8, k = t + 4 element 2t + 1): h's A fragment is two float2 loads (row
//     pad 8 floats: a half-warp's loads cover 32 banks), w's B fragment two
//     loads from k-rows 2t and 2t + 1 (row pad 4 floats: the warp's 8 x 4
//     loads fall on 32 banks).  An element is split into big + small once
//     a fragment load (tf32_tile.cuh's split): a B fragment serves the
//     warp's 4 m-tiles, an A fragment its 4 n-tiles; the three products
//     run as three passes over the n-tiles, so that back-to-back mma.sync
//     are independent;
//   * the grid is (token tiles, vocab tiles), token tiles fastest, so the
//     CTAs in flight share their w tile through L2.  In place of the TPU's
//     sequential vocab axis, each CTA writes per-token partials (max, sum
//     of exp, target logit) for its vocab tile: a row's max and sum of exp
//     over a quad (shuffles 1 and 2), then over the 4 warps that share the
//     row, through shared memory; a second small kernel folds them per token
//     (the online logsumexp's combine) and sums each 128-token tile's
//     mask * nll and mask;
//   * vocab ids past V are masked out of the max, the sum and the target
//     pick-up, as today.
// The bf16 route keeps the SIMT tile (ce_tile_kernel: 8 x 8 logits a
// thread, D 8 at a time, FMAs on the CUDA cores).  The warp tile (64 x 32 or
// 32 x 64 tokens x ids, REPRO_CE_WARP_M) and the stages (REPRO_CE_STAGES)
// are compile-time knobs so tile_study.py can build and time the others.
// Not done yet (later work): bf16 on the tensor cores, wgmma, TMA, a larger
// logits tile.
//
// Interface: plain C, loaded with ctypes.  The entry point returns the
// cudaError_t of its launches (0 on success); it launches on the given
// stream, does not synchronise and allocates nothing: the caller passes
// 3 * ceil(V / 128) * Tk floats of scratch for the partials.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "tf32_tile.cuh"

#ifndef REPRO_CE_WARP_M
#define REPRO_CE_WARP_M 64
#endif
#ifndef REPRO_CE_STAGES
#define REPRO_CE_STAGES 3
#endif

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

// ---------------------------------------------------------------------------
// The fp32 tile by 3xTF32
// ---------------------------------------------------------------------------
namespace ce_tf32 {

using tf32_tile::cp_async_commit;
using tf32_tile::cp_async_wait;
using tf32_tile::cp_async16;
using tf32_tile::mma1688;
using tf32_tile::split;

constexpr int kBK = 32;                          // D a stage
constexpr int kWarpM = REPRO_CE_WARP_M;          // tokens a warp
constexpr int kWarpN = kBT * kBV / 8 / kWarpM;   // vocab ids a warp
constexpr int kWarpsM = kBT / kWarpM;
constexpr int kWarpsN = kBV / kWarpN;
constexpr int kMT = kWarpM / 16, kNT = kWarpN / 8;   // mma tiles a warp
constexpr int kStages = REPRO_CE_STAGES;
constexpr int kLdA = kBK + 8;    // h rows (floats)
constexpr int kLdB = kBV + 4;    // w rows
constexpr int kStageA = kBT * kLdA, kStageB = kBK * kLdB;
constexpr size_t kSmem = (size_t)kStages * (kStageA + kStageB) * 4;
// CTAs an SM the shared memory allows (2 at 3 stages), told to ptxas
constexpr int kCtasPerSm = 2 * (kSmem + 1024) <= 228 * 1024 ? 2 : 1;
static_assert((kWarpM == 64 || kWarpM == 32) && kStages >= 2 &&
              kWarpsM * kWarpsN * 32 == kThreads &&
              3 * kWarpsN * kBT * 4 <= kSmem, "tile shape");

__device__ inline void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(mma_tile::smem_addr(dst)), "l"(src),
                  "r"(valid ? 4 : 0));
}

// elements j .. j + 3 of a row of n floats starting at src (row_ok: the row
// exists) into dst, zero where missing: one 16-byte copy where the rows are
// 16-byte aligned (vec), else four 4-byte ones
__device__ inline void copy4(float* dst, const float* row, bool row_ok,
                             int j, int n, bool vec) {
  if (vec) {
    const bool ok = row_ok && j < n;
    cp_async16(dst, ok ? row + j : row, ok);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = row_ok && j + e < n;
      cp_async4(dst + e, ok ? row + j + e : row, ok);
    }
  }
}

// Logits tile (token tile blockIdx.x, vocab tile blockIdx.y) -> per-token
// partials of this vocab tile: max, sum of exp(z - max), target logit.
// Warp (wm, wn) owns tokens wm * kWarpM .. and ids wn * kWarpN .. of it.
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
tile_kernel(const float* __restrict__ h, const float* __restrict__ w,
            const int* __restrict__ targets, float* __restrict__ part, int Tk,
            int D, int V, float softcap) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);    // [kStages][kBT][kLdA]
  float* Bs = As + kStages * kStageA;            // [kStages][kBK][kLdB]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wm = warp % kWarpsM, wn = warp / kWarpsM;
  const int t0 = blockIdx.x * kBT, v0 = blockIdx.y * kBV;
  const bool hvec = D % 4 == 0 && (uintptr_t)h % 16 == 0;
  const bool wvec = V % 4 == 0 && (uintptr_t)w % 16 == 0;
  const int steps = (D + kBK - 1) / kBK;

  // stage st of D (dims st * kBK ..) into ring slot st % kStages
  auto issue = [&](int st) {
    if (st >= steps) return;
    const int k0 = st * kBK;
    float* a = As + (st % kStages) * kStageA;
    float* b = Bs + (st % kStages) * kStageB;
    for (int i = tid; i < kBT * (kBK / 4); i += kThreads) {
      const int r = i / (kBK / 4), c = (i % (kBK / 4)) * 4;
      const int tok = t0 + r;
      copy4(a + r * kLdA + c, h + (size_t)min(tok, Tk - 1) * D + k0,
            tok < Tk, c, D - k0, hvec);
    }
    for (int i = tid; i < kBK * (kBV / 4); i += kThreads) {
      const int r = i / (kBV / 4), c = (i % (kBV / 4)) * 4;
      const int kd = k0 + r;
      copy4(b + r * kLdB + c, w + (size_t)min(kd, D - 1) * V + v0,
            kd < D, c, V - v0, wvec);
    }
  };

  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    issue(st);
    cp_async_commit();
  }
  for (int st = 0; st < steps; ++st) {
    cp_async_wait<kStages - 2>();
    // stage st has landed and every reader of the slot refilled below
    // (stage st - 1's) is done
    __syncthreads();
    issue(st + kStages - 1);
    cp_async_commit();
    const float* a = As + (st % kStages) * kStageA + wm * kWarpM * kLdA;
    const float* b = Bs + (st % kStages) * kStageB + wn * kWarpN + g;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      // B fragments of the warp's n-tiles: k-rows 2t and 2t + 1, column g
      uint32_t bb[kNT][2], bsm[kNT][2];
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        split(b[(kk + 2 * t4) * kLdB + n * 8], bb[n][0], bsm[n][0]);
        split(b[(kk + 2 * t4 + 1) * kLdB + n * 8], bb[n][1], bsm[n][1]);
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const float* ar = a + (mt * 16 + g) * kLdA + kk + 2 * t4;
        const float2 x0 = *reinterpret_cast<const float2*>(ar);
        const float2 x1 = *reinterpret_cast<const float2*>(ar + 8 * kLdA);
        uint32_t ab[4], as[4];
        split(x0.x, ab[0], as[0]);   // row g,     k = t
        split(x1.x, ab[1], as[1]);   // row g + 8, k = t
        split(x0.y, ab[2], as[2]);   // row g,     k = t + 4
        split(x1.y, ab[3], as[3]);   // row g + 8, k = t + 4
        // the three products as three passes over the n-tiles, so that
        // consecutive mma.sync write different accumulators (small terms
        // first, as tf32_tile.cuh's mma3 sums them)
#pragma unroll
        for (int n = 0; n < kNT; ++n)
          mma1688(acc[mt][n], as, bb[n][0], bb[n][1]);
#pragma unroll
        for (int n = 0; n < kNT; ++n)
          mma1688(acc[mt][n], ab, bsm[n][0], bsm[n][1]);
#pragma unroll
        for (int n = 0; n < kNT; ++n)
          mma1688(acc[mt][n], ab, bb[n][0], bb[n][1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free: the row reductions reuse it

  // per row: the warp's max, sum of exp and target logit over its ids
  // (a quad holds a row's 2 * kNT ids of the warp), then over the kWarpsN
  // warps that share the row
  float* red_m = As;                      // [kWarpsN][kBT]
  float* red_l = red_m + kWarpsN * kBT;
  float* red_t = red_l + kWarpsN * kBT;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = wm * kWarpM + mt * 16 + g + 8 * half;
      const int tok = t0 + row;
      const int tgt = tok < Tk ? targets[tok] : -1;
      float z[kNT][2];
      float mx = kNegInf, tz = 0.f;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = v0 + wn * kWarpN + n * 8 + 2 * t4 + j;
          float x = acc[mt][n][2 * half + j];
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          z[n][j] = c < V ? x : kNegInf;
          mx = fmaxf(mx, z[n][j]);
          if (c < V && c == tgt) tz += x;
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float l = 0.f;
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          if (v0 + wn * kWarpN + n * 8 + 2 * t4 + j < V)
            l += expf(z[n][j] - mx);
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        l += __shfl_xor_sync(0xffffffffu, l, o);
        tz += __shfl_xor_sync(0xffffffffu, tz, o);
      }
      if (t4 == 0) {
        red_m[wn * kBT + row] = mx;
        red_l[wn * kBT + row] = l;
        red_t[wn * kBT + row] = tz;
      }
    }
  }
  __syncthreads();
  if (tid < kBT && t0 + tid < Tk) {
    float M = kNegInf;
#pragma unroll
    for (int j = 0; j < kWarpsN; ++j) M = fmaxf(M, red_m[j * kBT + tid]);
    float L = 0.f, tz = 0.f;
#pragma unroll
    for (int j = 0; j < kWarpsN; ++j) {
      L += red_l[j * kBT + tid] * expf(red_m[j * kBT + tid] - M);
      tz += red_t[j * kBT + tid];
    }
    const size_t plane = (size_t)gridDim.y * Tk;
    const size_t at = (size_t)blockIdx.y * Tk + t0 + tid;
    part[at] = M;
    part[plane + at] = L;
    part[2 * plane + at] = tz;
  }
}

cudaError_t configure() {
  static bool done = false;
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  done = e == cudaSuccess;
  return e;
}

}  // namespace ce_tf32

template <typename T>
cudaError_t run(const void* h, const void* w, const int* targets,
                const float* mask, float* part, float* loss, float* count,
                int Tk, int D, int V, float softcap, cudaStream_t s) {
  const int n_tt = (Tk + kBT - 1) / kBT, n_vt = (V + kBV - 1) / kBV;
  const dim3 grid(n_tt, n_vt);
  if constexpr (sizeof(T) == 4) {
    cudaError_t e = ce_tf32::configure();
    if (e != cudaSuccess) return e;
    ce_tf32::tile_kernel<<<grid, kThreads, ce_tf32::kSmem, s>>>(
        static_cast<const float*>(h), static_cast<const float*>(w), targets,
        part, Tk, D, V, softcap);
  } else {
    ce_tile_kernel<T><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(h), static_cast<const T*>(w), targets, part,
        Tk, D, V, softcap);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ce_combine_kernel<<<n_tt, kBT, 0, s>>>(part, mask, loss, count, Tk, n_vt);
  return cudaGetLastError();
}

// out = {registers a thread, local (spill) bytes a thread, shared memory
// bytes a CTA, CTAs resident on one SM, tokens a CTA} of the dtype's tile
template <typename F>
cudaError_t query(F kern, size_t dyn_smem, int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kern);
  if (e != cudaSuccess) return e;
  int ctas = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kern, kThreads,
                                                    dyn_smem);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)(dyn_smem + attr.sharedSizeBytes);
  out[3] = ctas;
  out[4] = kBT;
  return e;
}

}  // namespace

extern "C" {

// K10.  h (Tk, D), w (D, V): dtype 0 = float32 (3xTF32 on the tensor
// cores), 1 = bfloat16 (SIMT); targets (Tk,) int32; mask (Tk,) float32;
// part: 3 * ceil(V/128) * Tk float32 scratch; loss, count: ceil(Tk/128)
// float32 each.
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

// Resources of K10's logits tile for dtype (0: the fp32 3xTF32 tile, 1: the
// bf16 SIMT tile; launches nothing): out[5] = registers a thread, spill
// bytes a thread, shared memory bytes a CTA, CTAs resident on one SM,
// tokens a CTA.
int chunked_ce_resources(int dtype, int* out) {
  if (dtype == 0) {
    cudaError_t e = ce_tf32::configure();
    if (e != cudaSuccess) return (int)e;
    return (int)query(ce_tf32::tile_kernel, ce_tf32::kSmem, out);
  }
  if (dtype == 1) return (int)query(ce_tile_kernel<__nv_bfloat16>, 0, out);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
