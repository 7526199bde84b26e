// K11's head-shared (Mamba-2) scan as a chunked scan on Hopper's tensor
// cores, the route csrc/mamba_scan.cu's mamba_scan_heads_chunked runs at a
// head dim P of 64 and a state size N of 16, 32 or 64 (zamba2's 80 heads of
// 64, N 64) where a call has more than one step; other shapes and the
// decode step keep mamba_scan.cu's head_scan_kernel / head_step_kernel.
//
// The function is the stepped scan's (kernels/mamba_scan/ref.py,
// scan_heads; the JAX package's layers/ssm.py, _mamba2_scan): for batch
// row b and head h, from h[-1] = h0 (P x N),
//   h[t] = exp(dt[t] A[h]) h[t-1] + (x[t] dt[t]) Bc[t]^T,  y[t] = h[t] Cc[t]
// with x[t] the head's P channels.  One decay a head and step and one Bc,
// Cc shared by every head let a chunk of L = 64 steps unroll into matrix
// products (the "dual" form of Mamba-2).  With a[t] = dt[t] A[h] log2(e),
// X = x dt (L x P) and Bc, Cc (L x N) of chunk c:
//   G = Cc Bc^T (L x L), once a CTA for all the heads it owns;
//   M[t][s] = exp2(sum_{s<r<=t} a[r]) for s <= t, else 0: each column a
//     running sum from s down the rows.  Never a difference of two long
//     cumulative sums: at A = -80 a step's a reaches ~-100 x log2(e), and
//     the fp32 ulp of a chunk's whole sum would move the short-range
//     decays by ~1e-3 relative;
//   E_c = (X o m)^T Bc (P x N), the chunk's end state from 0, m[s] =
//     exp2(sum_{r>s} a[r]) (suffix sums); decay_c = exp2(sum_r a[r]);
//   h_start[c] = decay_{c-1} h_start[c-1] + E_{c-1}, h_start[0] = h0, and
//     hT the fold after the last chunk (in h0's dtype, round to nearest
//     even);
//   y = (M o G) X + (e o Cc) h_start[c]^T, e[t] = exp2(sum_{r<=t} a[r]),
//     taken as one product over k = L + N: [W | e o Cc] [x ; h_start^T]
//     with W = (M o G) dt (dt of column s), so that W x = (M o G) X.
// A ragged last chunk reads dt = 0 past S (dA = 1, X = 0) and stores
// nothing there.
//
// What bounds it on this card: the bytes, at zamba2's prefill span (B 1, S
// 256, bf16) 9.2 MB of dt, x, Bc, Cc, h0 in and y, hT out (~2.8 us), beside
// the products it needs as TF32 passes, ~1.0 GFLOP (~2.0 us at 494.7
// TFLOP/s: lower triangles where M masks, two passes where x or Bc is
// bf16); at the training shape (B 2, S 2048, fp32) ~176 MB (~0.053 ms)
// beside ~20 GFLOP (~0.041 ms).  The three passes below move
// more: the chunks' end states are written, read and rewritten as the
// start states, and read again (~588 MB at the training shape, ~0.18 ms).
// The thread-a-channel walk this route replaces ran every state's fma and
// y's 64-long dependent chain on the CUDA cores.
//
// Precision: y is held at fp32 1e-4 and hT at its dtype's bound, so no
// fp32 operand is rounded to bf16 or to one TF32.  G, where Bc and Cc are
// bf16, is one bf16 m16n8k16 product with fp32 accumulation (its operands
// are exact); every other product (G in fp32, E_c, y's) runs by 3xTF32 as
// tf32_tile.cuh's: each fp32 operand split into big + small TF32 values
// and big.big + big.small + small.big summed in fp32.  Where one operand
// is bf16 (Bc in E_c, x in y's W x) its small part is exactly 0, so the
// product whose small part it is, which adds exactly 0, is not issued.
// Each k-step's product is summed apart from 0 and added to the running
// sum in fp32 (add4): the tensor cores' fp32 accumulation truncates, and
// one accumulator over a whole k loop left y past the 1e-4 bound at the
// training shape on an H100.
//
// What the design does, three launches:
//   * ends_kernel, a CTA of 4 warps per (chunk, batch row, group of
//     `heads` heads; the wrapper sizes the group so that the grid stays
//     four waves of the card's CTA slots or more): Bc of the chunk is
//     staged once; per head x and dt arrive by cp.async a head ahead, one
//     warp takes the suffix sums by shuffles, and E_c (warp w its 16
//     channels) and the decay go to the workspace;
//   * fold_kernel: a thread a 4-state vector of a (batch row, head) walks
//     the chunks, replacing E_c in the workspace by h_start[c] and folding
//     it in (the chunks' loads issued 8 at a time ahead of the fmas); hT
//     at the end;
//   * out_kernel, the grid of ends_kernel, 8 warps (4 row tiles of 16
//     steps x 2 halves of the 64 channels), at most 128 registers so that
//     two CTAs fit an SM: Bc and Cc staged, G into the registers of warps
//     0-3; per head x, dt and h_start staged, h_start (and fp32 x) split
//     into big and small TF32 in place once for all warps, two warps walk
//     the column running sums and one takes the prefix sums; warps 0-3
//     turn their own G elements into W over the segment sums in place
//     (the G accumulator's layout is the A fragment of y's first L columns:
//     tf32_tile.cuh's permuted k, k = t of a quad's thread t element 2t,
//     k = t + 4 element 2t + 1); k-steps wholly above a warp's last row (M
//     = 0) are skipped; y is written once.
// Every product issues its tensor-core instructions a phase at a time
// over its n-tiles (small.big for all, then big.small, then big.big, the
// first from a zero accumulator): the three of one n-tile depend on each
// other.  The k loops stay loops, only the n-tiles unrolled.  Shared rows
// are padded so that the fragments' 32- and 64-bit loads of a warp hit
// distinct banks.  Not done yet (later work): wgmma; overlapping a head's
// staging with the last head's products in out_kernel; fewer bytes
// between the passes; a backward kernel on the same chunks (the gradient
// is ref.scan_heads_grads, plain).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tile.cuh"
#include "tf32_tile.cuh"
#include "vec.cuh"

namespace {
namespace mamba_ssd {

using bf16 = __nv_bfloat16;
using mma_tile::cp_async16;
using mma_tile::cp_async_commit;
using mma_tile::cp_async_wait;
using mma_tile::mma16816;
using tf32_tile::mma1688;
using tf32_tile::split;

constexpr int kL = 64;          // steps a chunk
constexpr int kP = 64;          // channels a head
constexpr int kThreads = 128;   // 4 warps
constexpr int kFoldVec = 4;     // fold_kernel: states a thread
constexpr int kMaxHeads = 8;    // heads a chunk CTA, at most
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
constexpr bool kIsBf16 = std::is_same<T, bf16>::value;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// two adjacent values of T at p as fp32 (p 4-byte aligned for bf16,
// 8-byte for fp32)
__device__ __forceinline__ float2 pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// the fp32 bits of a bf16 value: a TF32 value as it stands
__device__ __forceinline__ uint32_t tf32_bits(float v) {
  return __float_as_uint(v);
}

// c += p: a k-step's product, summed apart from 0 on the tensor cores, is
// added to the running sum in fp32 with round-to-nearest
__device__ __forceinline__ void add4(float (&c)[4], const float (&p)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += p[e];
}

// d = a * b from zero (no accumulator to clear): m16n8k8 TF32 and
// m16n8k16 bf16, fp32 out
__device__ __forceinline__ void mma1688_z(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}
__device__ __forceinline__ void mma16816_z(float (&d)[4],
                                           const uint32_t (&a)[4],
                                           uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// One k-step of 8 of a 16-row product by 3xTF32 over NT n-tiles, its
// tensor-core instructions a phase at a time: acc[n] += a * b[n], the
// k-step summed apart from 0.  bb / bs: each n-tile's B fragment, big and
// small; kExactB: B is exact in TF32 (bf16 values), bs unused.
template <int NT, bool kExactB = false>
__device__ __forceinline__ void kstep3(float (&acc)[NT][4],
                                       const uint32_t (&ab)[4],
                                       const uint32_t (&as)[4],
                                       const uint32_t (&bb)[NT][2],
                                       const uint32_t (&bs)[NT][2]) {
  float p[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) mma1688_z(p[n], as, bb[n][0], bb[n][1]);
  if constexpr (!kExactB) {
#pragma unroll
    for (int n = 0; n < NT; ++n) mma1688(p[n], ab, bs[n][0], bs[n][1]);
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) mma1688(p[n], ab, bb[n][0], bb[n][1]);
#pragma unroll
  for (int n = 0; n < NT; ++n) add4(acc[n], p[n]);
}

// 4 bytes from global into shared memory, zero where !valid (src must be a
// readable address either way)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(mma_tile::smem_addr(dst)), "l"(src),
                  "r"(valid ? 4 : 0));
}

// rows r < nt of `rows` rows of `cols` T (row stride src_ld elements in
// global memory, dst_ld in shared), zero from nt on: 16-byte cp.async
// copies where `vec` (the base lies 16-byte aligned and every row offset
// is a multiple of 16 bytes), else plain loads and stores, which the
// barrier before the first read orders
template <typename T, int NTH = kThreads>
__device__ __forceinline__ void stage(T* dst, int dst_ld, const T* src,
                                      size_t src_ld, int rows, int cols,
                                      int nt, bool vec) {
  constexpr int EL = 16 / (int)sizeof(T);
  const int vr = cols / EL;
  if (vec) {
    for (int i = threadIdx.x; i < rows * vr; i += NTH) {
      const int r = i / vr, e = (i % vr) * EL;
      const bool ok = r < nt;
      cp_async16(dst + r * dst_ld + e, src + (ok ? r * src_ld + e : 0), ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += NTH) {
      const int r = i / cols, e = i % cols;
      dst[r * dst_ld + e] = r < nt ? src[r * src_ld + e] : T(0.f);
    }
  }
}

// a chunk CTA's place: chunk c of batch row b, heads h_first .. h_end - 1
struct ChunkPos {
  int c, b, nc, t0, nt, h_first, h_end;
  size_t row0;   // the chunk's first (b, t) row
  __device__ ChunkPos(int S, int H, int heads)
      : c(blockIdx.x), b(blockIdx.y), nc(gridDim.x), t0(c * kL),
        nt(min(kL, S - t0)), h_first(blockIdx.z * heads),
        h_end(min(H, h_first + heads)), row0((size_t)b * S + t0) {}
};

// ---------------------------------------------------------------------------
// ends_kernel: the chunks' end states from 0 and their decays
// ---------------------------------------------------------------------------

template <int N, typename T>
struct EndsShape {
  // Bc and x rows (elements of T): 4 mod 16 floats, 4 mod 32 words
  static constexpr int kLdB = kIsBf16<T> ? N + 8 : N + 4;
  static constexpr int kLdX = kIsBf16<T> ? kP + 8 : kP + 4;
  static constexpr size_t kSmem =
      ((size_t)kL * kLdB + 2 * (size_t)kL * kLdX) * sizeof(T)
      + 3 * (size_t)kL * 4;
  static_assert(N % 16 == 0 && N <= 64, "mamba_ssd state size");
};

// grid (chunks, B, ceil(H / heads)); ws: E (B, chunks, H, P, N), then the
// decays (B, chunks, H)
template <int N, typename T>
__global__ void __launch_bounds__(kThreads)
ends_kernel(const float* __restrict__ dt, const float* __restrict__ A,
            const T* __restrict__ x, const T* __restrict__ bc,
            float* __restrict__ ws, int S, int H, int heads) {
  using Sh = EndsShape<N, T>;
  constexpr bool BF = kIsBf16<T>;
  constexpr int LDB = Sh::kLdB, LDX = Sh::kLdX, NT = N / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Bs = reinterpret_cast<T*>(smem);             // [kL][LDB]
  T* Xr = Bs + kL * LDB;                          // [2][kL][LDX]: x, raw
  float* Ds = reinterpret_cast<float*>(Xr + 2 * kL * LDX);   // [2][kL]: dt
  float* Ml = Ds + 2 * kL;                        // exp2(sum_{r>s} a[r])

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const ChunkPos at(S, H, heads);
  const size_t E = (size_t)H * kP;
  const bool xvec = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  auto issue = [&](int hh, int buf) {   // head hh's x and dt into buf
    stage(Xr + buf * kL * LDX, LDX, x + at.row0 * E + (size_t)hh * kP, E,
          kL, kP, at.nt, xvec);
    if (tid < kL)
      cp_async4(Ds + buf * kL + tid,
                dt + (at.row0 + (tid < at.nt ? tid : 0)) * H + hh,
                tid < at.nt);
  };
  stage(Bs, LDB, bc + at.row0 * N, (size_t)N, kL, N, at.nt,
        (reinterpret_cast<uintptr_t>(bc) & 15) == 0);
  issue(at.h_first, 0);
  cp_async_commit();

  float* ends = ws + ((size_t)at.b * at.nc + at.c) * H * kP * N;
  float* decays = ws + (size_t)gridDim.y * at.nc * H * kP * N
                  + ((size_t)at.b * at.nc + at.c) * H;
  const int pa = warp * 16 + g, pb = pa + 8;   // the thread's channels
  for (int hh = at.h_first; hh < at.h_end; ++hh) {
    const int buf = (hh - at.h_first) & 1;
    cp_async_wait<0>();
    // head hh's x and dt are in; every reader of the other buffer and of
    // Ml (the last head) is done
    __syncthreads();
    if (hh + 1 < at.h_end) issue(hh + 1, buf ^ 1);
    cp_async_commit();
    const T* Xh = Xr + buf * kL * LDX;
    const float* Dh = Ds + buf * kL;
    if (warp == 0) {
      // suffix sums over the steps reversed: lane l holds steps 63 - l and
      // 31 - l; its inclusive prefix is then sum_{r >= 63-l} a (lo) and
      // sum_{r >= 31-l} a (hi)
      const float a2 = A[hh] * kLog2e;
      float lo = Dh[63 - lane] * a2, hi = Dh[31 - lane] * a2;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float l2 = __shfl_up_sync(0xffffffffu, lo, o);
        const float h2 = __shfl_up_sync(0xffffffffu, hi, o);
        if (lane >= o) {
          lo += l2;
          hi += h2;
        }
      }
      hi += __shfl_sync(0xffffffffu, lo, 31);
      // m[s] = exp2(sum_{r>s} a[r]): s = 62 - l from lo, 30 - l from hi
      if (lane < 31) {
        Ml[62 - lane] = exp2f(lo);
        Ml[30 - lane] = exp2f(hi);
      } else {
        Ml[63] = 1.f;
        Ml[31] = exp2f(lo);
        decays[hh] = exp2f(hi);   // the whole chunk's sum
      }
    }
    __syncthreads();

    // E_c = (X o m)^T Bc: the warp's 16 channels by the N states
    float acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll 1
    for (int j = 0; j < 8; ++j) {
      const int s0 = 8 * j + 2 * t4;
      const float d0 = Dh[s0], d1 = Dh[s0 + 1];
      const float m0 = Ml[s0], m1 = Ml[s0 + 1];
      // A fragment (permuted k): X[s0][pa] m0, X[s0][pb] m0, X[s0+1][pa]
      // m1, X[s0+1][pb] m1, X = x dt
      const float av[4] = {to_f32(Xh[s0 * LDX + pa]) * d0 * m0,
                           to_f32(Xh[s0 * LDX + pb]) * d0 * m0,
                           to_f32(Xh[(s0 + 1) * LDX + pa]) * d1 * m1,
                           to_f32(Xh[(s0 + 1) * LDX + pb]) * d1 * m1};
      uint32_t ab[4], as[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split(av[e], ab[e], as[e]);
      uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float b0 = to_f32(Bs[s0 * LDB + 8 * n + g]);
        const float b1 = to_f32(Bs[(s0 + 1) * LDB + 8 * n + g]);
        if constexpr (BF) {   // Bc exact in TF32: its small part is 0
          bb[n][0] = tf32_bits(b0);
          bb[n][1] = tf32_bits(b1);
        } else {
          split(b0, bb[n][0], bs[n][0]);
          split(b1, bb[n][1], bs[n][1]);
        }
      }
      kstep3<NT, BF>(acc, ab, as, bb, bs);
    }
    float* ea = ends + ((size_t)hh * kP + pa) * N + 2 * t4;
    float* eb = ends + ((size_t)hh * kP + pb) * N + 2 * t4;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      *reinterpret_cast<float2*>(ea + 8 * n) =
          make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(eb + 8 * n) =
          make_float2(acc[n][2], acc[n][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// fold_kernel: the states at the chunks' starts, and hT
// ---------------------------------------------------------------------------

// grid (ceil(P * N / (4 * kThreads)), H, B): a thread 4 states of a (b, h);
// ws's E_c becomes h_start[c]
template <int N, typename HT>
__global__ void __launch_bounds__(kThreads)
fold_kernel(const HT* __restrict__ h0, HT* __restrict__ hT,
            float* __restrict__ ws, int nc, int H) {
  constexpr int kState = kP * N;
  constexpr int U = 8;   // chunks whose loads go out together
  const int v = blockIdx.x * kThreads + threadIdx.x;   // 4-state vector
  if (v * kFoldVec >= kState) return;
  const int hh = blockIdx.y, b = blockIdx.z;
  const size_t n_ends = (size_t)gridDim.z * nc * H * kState;
  float h[kFoldVec];
  const HT* src = h0 + ((size_t)b * H + hh) * kState + v * kFoldVec;
#pragma unroll
  for (int u = 0; u < kFoldVec; ++u) h[u] = to_f32(src[u]);
  for (int c0 = 0; c0 < nc; c0 += U) {
    float4 e[U];
    float dec[U];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      if (c0 + i < nc) {
        const size_t slot = ((size_t)b * nc + c0 + i) * H + hh;
        e[i] = *reinterpret_cast<const float4*>(ws + slot * kState
                                                + v * kFoldVec);
        dec[i] = ws[n_ends + slot];
      }
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      if (c0 + i < nc) {
        const size_t slot = ((size_t)b * nc + c0 + i) * H + hh;
        *reinterpret_cast<float4*>(ws + slot * kState + v * kFoldVec) =
            make_float4(h[0], h[1], h[2], h[3]);   // h_start[c]
        h[0] = fmaf(dec[i], h[0], e[i].x);
        h[1] = fmaf(dec[i], h[1], e[i].y);
        h[2] = fmaf(dec[i], h[2], e[i].z);
        h[3] = fmaf(dec[i], h[3], e[i].w);
      }
    }
  }
  HT* dst = hT + ((size_t)b * H + hh) * kState + v * kFoldVec;
#pragma unroll
  for (int u = 0; u < kFoldVec; ++u) store_out(dst + u, h[u]);   // RNE
}

// ---------------------------------------------------------------------------
// out_kernel: y = (M o G) X + (e o Cc) h_start^T
// ---------------------------------------------------------------------------

constexpr int kOutThreads = 256;   // 8 warps: 4 row tiles x 2 column halves

template <int N, typename T>
struct OutShape {
  static constexpr bool kBf16 = kIsBf16<T>;
  static constexpr int kLdC = N + 8;   // Bc, Cc rows (T)
  // x rows: bf16 as it is (exact in TF32), fp32 split into big and small
  // (words); 4 mod 32 words either way
  static constexpr int kLdX = kBf16 ? kP + 8 : kP + 4;
  static constexpr int kLdH = N + 8;   // h_start rows, big and small
  static constexpr int kLdS = kL + 8;  // segment sums, then W (floats)
  static constexpr size_t kXBytes = kBf16 ? (size_t)kL * kLdX * 2
                                          : 2 * (size_t)kL * kLdX * 4;
  static constexpr size_t kHBytes = (size_t)kP * kLdH * 4;
  static constexpr size_t kSmem = (size_t)kL * kLdC * sizeof(T) + kXBytes
      + 2 * kHBytes + ((size_t)kL * kLdS + 2 * (size_t)kL) * 4;
  static_assert(N % 16 == 0 && N <= 64 &&
                (size_t)kL * kLdC * sizeof(T) <= kHBytes,
                "mamba_ssd state size");
};

// grid (chunks, B, ceil(H / heads)); ws holds h_start (fold_kernel's)
template <int N, typename T>
__global__ void __launch_bounds__(kOutThreads, 2)
out_kernel(const float* __restrict__ dt, const float* __restrict__ A,
           const T* __restrict__ x, const T* __restrict__ bc,
           const T* __restrict__ cc, const float* __restrict__ ws,
           float* __restrict__ y, int S, int H, int heads) {
  using Sh = OutShape<N, T>;
  constexpr bool BF = kIsBf16<T>;
  constexpr int LDC = Sh::kLdC, LDX = Sh::kLdX, LDH = Sh::kLdH;
  constexpr int LDS = Sh::kLdS;
  constexpr int XV = kL * kP / kOutThreads;   // x values a thread splits
  constexpr int HV = kP * N / kOutThreads;    // h_start values
  extern __shared__ __align__(16) unsigned char smem[];
  T* Cs = reinterpret_cast<T*>(smem);                       // [kL][LDC]
  unsigned char* xbuf = smem + (size_t)kL * LDC * sizeof(T);
  T* Xr = reinterpret_cast<T*>(xbuf);             // [kL][LDX]: x as staged
  uint32_t* Xb = reinterpret_cast<uint32_t*>(xbuf);   // fp32: big, small
  uint32_t* Xs = Xb + kL * LDX;
  uint32_t* Hb = reinterpret_cast<uint32_t*>(xbuf + Sh::kXBytes);
  uint32_t* Hs = Hb + kP * LDH;                             // [kP][LDH]
  float* Sg = reinterpret_cast<float*>(Hs + kP * LDH);      // [kL][LDS]
  float* Ds = Sg + kL * LDS;                                // dt
  float* Ev = Ds + kL;                            // exp2(sum_{r<=t} a[r])
  T* Bs = reinterpret_cast<T*>(Hb);               // Bc, for G only

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int rw = warp % 4, col0 = (warp / 4) * 32;   // rows, channels
  const int ra = rw * 16 + g, rb = ra + 8;
  const ChunkPos at(S, H, heads);
  const size_t E = (size_t)H * kP;
  const bool xvec = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const float* starts = ws + ((size_t)at.b * at.nc + at.c) * H * kP * N;

  stage<T, kOutThreads>(Bs, LDC, bc + at.row0 * N, (size_t)N, kL, N, at.nt,
                        (reinterpret_cast<uintptr_t>(bc) & 15) == 0);
  stage<T, kOutThreads>(Cs, LDC, cc + at.row0 * N, (size_t)N, kL, N, at.nt,
                        (reinterpret_cast<uintptr_t>(cc) & 15) == 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // G = Cc Bc^T, rows ra, rb by the 64 columns: warps 0-3, into registers
  float G[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) G[j][e] = 0.f;
  if (warp < 4) {
    if constexpr (BF) {   // exact bf16 products, fp32 sums
      constexpr int LW = LDC / 2;   // words a row
      const uint32_t* Cw = reinterpret_cast<const uint32_t*>(Cs);
      const uint32_t* Bw = reinterpret_cast<const uint32_t*>(Bs);
#pragma unroll 1
      for (int ks = 0; ks < N / 16; ++ks) {
        const int kw = ks * 8 + t4;
        const uint32_t a[4] = {Cw[ra * LW + kw], Cw[rb * LW + kw],
                               Cw[ra * LW + kw + 4], Cw[rb * LW + kw + 4]};
        float p[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mma16816_z(p[j], a, Bw[(8 * j + g) * LW + kw],
                     Bw[(8 * j + g) * LW + kw + 4]);
#pragma unroll
        for (int j = 0; j < 8; ++j) add4(G[j], p[j]);
      }
    } else {              // 3xTF32, permuted k: float2 fragments
#pragma unroll 1
      for (int ks = 0; ks < N / 8; ++ks) {
        const int k = ks * 8 + 2 * t4;
        const float2 ca = pair(Cs + ra * LDC + k);
        const float2 cb = pair(Cs + rb * LDC + k);
        const float av[4] = {ca.x, cb.x, ca.y, cb.y};
        uint32_t ab[4], as[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split(av[e], ab[e], as[e]);
        uint32_t bb[8][2], bs[8][2];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 bv = pair(Bs + (8 * j + g) * LDC + k);
          split(bv.x, bb[j][0], bs[j][0]);
          split(bv.y, bb[j][1], bs[j][1]);
        }
        kstep3<8>(G, ab, as, bb, bs);
      }
    }
  }

  for (int hh = at.h_first; hh < at.h_end; ++hh) {
    // every reader of the last head's buffers (and, the first time, G's
    // of Bc) is done
    __syncthreads();
    stage<T, kOutThreads>(Xr, LDX, x + at.row0 * E + (size_t)hh * kP, E,
                          kL, kP, at.nt, xvec);
    stage<float, kOutThreads>(reinterpret_cast<float*>(Hb), LDH,
                              starts + (size_t)hh * kP * N, (size_t)N, kP,
                              N, kP, true);
    if (tid < kL)
      cp_async4(Ds + tid, dt + (at.row0 + (tid < at.nt ? tid : 0)) * H + hh,
                tid < at.nt);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // h_start and fp32 x into big and small TF32 in place, once for every
    // warp (each value split by the thread that reads it)
    if constexpr (!BF) {
#pragma unroll
      for (int i = 0; i < XV; ++i) {
        const int v = tid + i * kOutThreads, r = v / kP, p = v % kP;
        split(__uint_as_float(Xb[r * LDX + p]), Xb[r * LDX + p],
              Xs[r * LDX + p]);
      }
    }
#pragma unroll
    for (int i = 0; i < HV; ++i) {
      const int v = tid + i * kOutThreads, r = v / N, n = v % N;
      split(__uint_as_float(Hb[r * LDH + n]), Hb[r * LDH + n],
            Hs[r * LDH + n]);
    }
    const float a2 = A[hh] * kLog2e;
    if (warp < 2) {
      // column s of the segment sums: Sg[t][s] = sum_{s<r<=t} a[r], a
      // running sum down the rows (rows above s are never read)
      const int s = tid;
      float run = 0.f;
      Sg[s * LDS + s] = 0.f;
#pragma unroll 8
      for (int t = 1; t < kL; ++t) {
        const float a = Ds[t] * a2;
        if (t > s) {
          run += a;
          Sg[t * LDS + s] = run;
        }
      }
    } else if (warp == 2) {
      // prefix sums: steps lane and lane + 32
      float lo = Ds[lane] * a2, hi = Ds[lane + 32] * a2;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float l2 = __shfl_up_sync(0xffffffffu, lo, o);
        const float h2 = __shfl_up_sync(0xffffffffu, hi, o);
        if (lane >= o) {
          lo += l2;
          hi += h2;
        }
      }
      hi += __shfl_sync(0xffffffffu, lo, 31);
      Ev[lane] = exp2f(lo);
      Ev[lane + 32] = exp2f(hi);
    }
    __syncthreads();
    const int jw = 2 * rw + 2;   // k-steps of 8 steps the warp's rows see
    if (warp < 4) {
      // W = (M o G) dt over the segment sums, in place (dt of column s: X
      // = x dt, so W x = (M o G) X): each thread its own G elements
      // (k-steps past the rows' last are never read)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < jw) {
          const int s0 = 8 * j + 2 * t4;
          const float d0 = Ds[s0], d1 = Ds[s0 + 1];
          float2* wa = reinterpret_cast<float2*>(Sg + ra * LDS + s0);
          float2* wb = reinterpret_cast<float2*>(Sg + rb * LDS + s0);
          const float2 sa = *wa, sb = *wb;
          *wa = make_float2(s0 <= ra ? exp2f(sa.x) * G[j][0] * d0 : 0.f,
                            s0 < ra ? exp2f(sa.y) * G[j][1] * d1 : 0.f);
          *wb = make_float2(s0 <= rb ? exp2f(sb.x) * G[j][2] * d0 : 0.f,
                            s0 < rb ? exp2f(sb.y) * G[j][3] * d1 : 0.f);
        }
      }
    }
    __syncthreads();

    // y over k = [the L steps | the N states], W x + (e o Cc) h_start^T:
    // the warp's 16 rows by its 32 channels
    float acc[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll 1
    for (int j = 0; j < jw; ++j) {
      const int s0 = 8 * j + 2 * t4;
      const float2 sa = pair(Sg + ra * LDS + s0);
      const float2 sb = pair(Sg + rb * LDS + s0);
      // A fragment (permuted k): W[ra][s0], W[rb][s0], W[ra][s0+1],
      // W[rb][s0+1]
      const float w[4] = {sa.x, sb.x, sa.y, sb.y};
      uint32_t ab[4], as[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split(w[e], ab[e], as[e]);
      uint32_t bb[4][2], bs[4][2];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int p = col0 + 8 * n + g;
        if constexpr (BF) {   // x exact in TF32: its small part is 0
          bb[n][0] = tf32_bits(to_f32(Xr[s0 * LDX + p]));
          bb[n][1] = tf32_bits(to_f32(Xr[(s0 + 1) * LDX + p]));
        } else {
          bb[n][0] = Xb[s0 * LDX + p];
          bb[n][1] = Xb[(s0 + 1) * LDX + p];
          bs[n][0] = Xs[s0 * LDX + p];
          bs[n][1] = Xs[(s0 + 1) * LDX + p];
        }
      }
      kstep3<4, BF>(acc, ab, as, bb, bs);
    }
    const float ea = Ev[ra], eb = Ev[rb];
#pragma unroll 1
    for (int ks = 0; ks < N / 8; ++ks) {
      const int k = 8 * ks + 2 * t4;
      const float2 ca = pair(Cs + ra * LDC + k);
      const float2 cb = pair(Cs + rb * LDC + k);
      // A fragment: (e o Cc)[ra][k], [rb][k], [ra][k+1], [rb][k+1]
      const float av[4] = {ea * ca.x, eb * cb.x, ea * ca.y, eb * cb.y};
      uint32_t ab[4], as[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split(av[e], ab[e], as[e]);
      uint32_t bb[4][2], bs[4][2];
#pragma unroll
      for (int n = 0; n < 4; ++n) {   // h_start^T: [k][p] = h[p][k]
        const int p = col0 + 8 * n + g;
        const uint2 hb = *reinterpret_cast<const uint2*>(Hb + p * LDH + k);
        const uint2 hs = *reinterpret_cast<const uint2*>(Hs + p * LDH + k);
        bb[n][0] = hb.x;
        bb[n][1] = hb.y;
        bs[n][0] = hs.x;
        bs[n][1] = hs.y;
      }
      kstep3<4>(acc, ab, as, bb, bs);
    }
    float* ya = y + ((at.row0 + ra) * H + hh) * kP + col0 + 2 * t4;
    float* yb = y + ((at.row0 + rb) * H + hh) * kP + col0 + 2 * t4;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      if (ra < at.nt)
        *reinterpret_cast<float2*>(ya + 8 * n) =
            make_float2(acc[n][0], acc[n][1]);
      if (rb < at.nt)
        *reinterpret_cast<float2*>(yb + 8 * n) =
            make_float2(acc[n][2], acc[n][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launch and resources
// ---------------------------------------------------------------------------

// the dynamic shared memory past 48 KB a kernel asks for, once
template <typename K>
cudaError_t configure(K kern, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  done = e == cudaSuccess;
  return e;
}

template <int N, typename T>
cudaError_t configure_both() {
  static bool ends_done = false, out_done = false;
  const cudaError_t e = configure(ends_kernel<N, T>, EndsShape<N, T>::kSmem,
                                  ends_done);
  if (e != cudaSuccess) return e;
  return configure(out_kernel<N, T>, OutShape<N, T>::kSmem, out_done);
}

// ws: B * ceil(S / kL) * H * (kP * N + 1) floats
template <int N, typename T, typename HT>
cudaError_t launch(const float* dt, const float* A, const T* x, const T* bc,
                   const T* cc, const HT* h0, float* y, HT* hT, float* ws,
                   int B, int S, int H, int heads, cudaStream_t stream) {
  cudaError_t e = configure_both<N, T>();
  if (e != cudaSuccess) return e;
  const int nc = (S + kL - 1) / kL;
  const dim3 chunks(nc, B, (H + heads - 1) / heads);
  ends_kernel<N, T><<<chunks, kThreads, EndsShape<N, T>::kSmem, stream>>>(
      dt, A, x, bc, ws, S, H, heads);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int vecs = kP * N / kFoldVec;
  fold_kernel<N, HT><<<dim3((vecs + kThreads - 1) / kThreads, H, B),
                       kThreads, 0, stream>>>(h0, hT, ws, nc, H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  out_kernel<N, T><<<chunks, kOutThreads, OutShape<N, T>::kSmem, stream>>>(
      dt, A, x, bc, cc, ws, y, S, H, heads);
  return cudaGetLastError();
}

template <typename K>
cudaError_t query(K kern, int threads, size_t dyn, int* out, int per_cta) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kern);
  if (e != cudaSuccess) return e;
  int ctas = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kern, threads,
                                                    dyn);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)(dyn + attr.sharedSizeBytes);
  out[3] = ctas;
  out[4] = per_cta;
  return e;
}

// out = {registers a thread, spill bytes a thread, shared memory bytes a
// CTA, CTAs resident on one SM, steps (passes 1, 3) or states (pass 2) a
// CTA}; pass 1 ends_kernel, 2 fold_kernel, 3 out_kernel
template <int N, typename T, typename HT>
cudaError_t resources(int pass, int* out) {
  const cudaError_t e = configure_both<N, T>();
  if (e != cudaSuccess) return e;
  if (pass == 1)
    return query(ends_kernel<N, T>, kThreads, EndsShape<N, T>::kSmem, out,
                 kL);
  if (pass == 2)
    return query(fold_kernel<N, HT>, kThreads, 0, out, kThreads * kFoldVec);
  if (pass == 3)
    return query(out_kernel<N, T>, kOutThreads, OutShape<N, T>::kSmem, out,
                 kL);
  return cudaErrorInvalidValue;
}

}  // namespace mamba_ssd
}  // namespace
