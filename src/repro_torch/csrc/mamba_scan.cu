// Mamba selective scan for Hopper (sm_90a): K11.
//
// Replaces the TPU kernel of the JAX package:
//   K11  src/repro/kernels/mamba_scan/kernel.py  mamba_scan (_scan_kernel)
// and runs the Mamba-2 scan the JAX package writes as a lax.scan
// (src/repro/layers/ssm.py, _mamba2_scan) in its head-shared form.
//
// The recurrence, for batch row b, channel e < E and state n < N, from
// h[-1] = h0, in fp32:
//   h[t][e][n] = dA[t][e][n] * h[t-1][e][n] + dBx[t][e][n]
//   y[t][e]    = sum_n h[t][e][n] * C[t][n]
// returning y (B, S, E) and the last state hT (B, E, N).  Three entry
// points share one body:
//   * mamba_scan_model: the tensors the model has (layers/ssm.py,
//     apply_mamba1): dt and x (B, S, E), Bc and Cc (B, S, N) in the model's
//     dtype (float32 or bfloat16), A (E, N) float32 and h0 (B, E, N) float32
//     or bfloat16; it discretizes itself, dA = exp2f(dt * A2[e][n]) with
//     A2 = A * log2(e) formed once a thread (one multiply and one MUFU.EX2
//     a state, not expf's range reduction; the build has no fast math) and
//     dBx = (dt * x) * Bc[n], the reference's order of products, so the
//     (B, S, E, N) dA and dBx (1 MiB a token a layer at falcon-mamba's
//     E 8192, N 16) never reach device memory; y and hT in float32;
//   * mamba_scan_heads: the head-shared (Mamba-2) form (layers/ssm.py,
//     apply_mamba2): channel e = h * P + p of head h; dt (B, S, H) and A
//     (H,) float32, one of each a head, x (B, S, E) and Bc, Cc (B, S, N) in
//     the model's dtype, h0 (B, H, P, N) float32 or bfloat16;
//     dA = exp2f(dt * A2[h]) is one exponential a head and step (taken by
//     each thread of the head: no shuffle), dBx = (x * dt) * Bc[n], the
//     reference's order of products; y (B, S, H, P) in float32 and hT in
//     h0's dtype (the reference's cast, round-to-nearest-even, done in the
//     kernel).  At a head dim of 64 and N 16, 32 or 64 (zamba2's heads)
//     with more than one step, the wrapper runs it as a chunked scan on the
//     tensor cores instead (mamba_scan_heads_chunked, ssd_scan.cuh: chunks
//     of 64 steps as matrix products, a fold over the chunks between); the
//     thread-a-channel kernels below take every other shape and the
//     decode step;
//   * mamba_scan_contract: the Pallas kernel's contract, for the parity
//     tests: dA and dBx (B, S, E, N), C (B, S, N) and h0 (B, E, N) in one
//     dtype (float32 or bfloat16), read a step at a time; y and hT in that
//     dtype.
//
// What bounds it on this card: at falcon-mamba's serve prefill (B 8, S 1024,
// E 8192, N 16, bf16) the model form moves dt, x (bf16) and y (fp32), ~0.54
// GB, 0.16 ms at 3.35 TB/s; it also takes B*S*E*N = 1.07 G exponentials,
// which the special-function units issue at 16 a clock an SM (~0.26 ms on
// 132 SMs at 1.98 GHz): the exponentials set the floor.  The time walk is
// sequential, but the N states of a channel are N independent chains.
//
// What the design does about it:
//   * the Pallas grid is (B, E / 512), each program a (512, N) fp32 state
//     tile in VMEM walking time; here a thread owns one channel: its N
//     states and A's row in registers, so y[t] is an in-register sum of N
//     products (no shuffle) and each step offers N independent chains;
//   * dt and x load straight from device memory, consecutive channels on
//     consecutive threads (coalesced), a round of kSteps steps ahead in
//     registers; Bc and Cc (N values a step, shared by every channel) are
//     loaded a round ahead the same way by the whole CTA and staged in
//     shared memory (2 buffers, one __syncthreads a round), read as
//     broadcasts; y is stored from the thread, coalesced;
//   * where B*E channel threads leave most of the card's slots empty (the
//     training shape, B 2), time is cut into `parts` chunks: pass 1 runs
//     chunks 0 .. parts-2 from h = 0 and writes each one's end state and
//     its decay exp2(A2 * sum dt) (N exponentials a chunk, not one a step)
//     to a workspace; pass 2 folds the chunks before its own into its
//     start state (h = decay * h + h_end, from h0) and reruns its chunk,
//     writing y and, in the last chunk, hT.  The wrapper picks parts from
//     the shapes (kernels/mamba_scan/kernel.py, scan_parts);
//   * a decode step (S 1) runs a kernel of its own: a thread does the one
//     step, h0 read and hT written as 16-byte vectors where aligned, no
//     staging and no barrier;
//   * ragged E is masked (a thread past E holds h = 0, stores nothing and
//     still takes its part in staging and barriers); the last round of a
//     chunk is short.
// The steps a round are a compile-time knob (REPRO_SCAN_STEPS; 8 at most
// for N 32) so tile_study.py can build and time others: a longer round
// keeps more steps' dt and x in registers (255 a thread at 16 steps, 2
// CTAs an SM), and the prefill ran 0.92 ms at 16 against 0.56 at 4 (an
// H100 80GB HBM3 at 700 W).  Not done yet
// (later work): a backward kernel for either form (the head-shared one on
// ssd_scan.cuh's chunks).  The gradients are plain
// PyTorch (kernels/mamba_scan/ref.py): Mamba-1's the adjoint stepped back
// a time step at a time (scan_model_grads), the head-shared form's the
// chunked form differentiated, batched products with no loop over time
// (scan_heads_grads, through kernel.py's _MambaScanHeads).
//
// Interface: plain C, loaded with ctypes.  The entry points return the
// cudaError_t of their launch (0 on success); they launch on the given
// stream, do not synchronise and allocate nothing (the wrapper allocates
// pass 1's workspace).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "ssd_scan.cuh"
#include "vec.cuh"

#ifndef REPRO_SCAN_STEPS
#define REPRO_SCAN_STEPS 4
#endif

namespace {
namespace mamba {

constexpr int kThreads = 128;    // channels a CTA, one a thread
constexpr int kMaxParts = 16;    // time chunks a call
constexpr float kLog2e = 1.4426950408889634f;

// time steps a round
template <int N>
struct Tile {
  static constexpr int kSteps =
      N >= 32 && REPRO_SCAN_STEPS > 8 ? 8 : REPRO_SCAN_STEPS;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// a thread's N contiguous values: 16-byte vectors where the row allows them
// and lies 16-byte aligned, else one element at a time
template <int N, typename T>
__device__ __forceinline__ void load_row(const T* p, float (&v)[N]) {
  constexpr int EL = 16 / (int)sizeof(T);
  if constexpr (N % EL == 0) {
    if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll
      for (int i = 0; i < N / EL; ++i)
        Vec<T>::convert(ld16(p + i * EL), v + i * EL);
      return;
    }
  }
#pragma unroll
  for (int n = 0; n < N; ++n) v[n] = to_f32(p[n]);
}

template <int N, typename T>
__device__ __forceinline__ void store_row(T* p, const float (&v)[N]) {
  if constexpr (std::is_same<T, float>::value && N % 4 == 0) {
    if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll
      for (int i = 0; i < N / 4; ++i)
        reinterpret_cast<float4*>(p)[i] =
            make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
      return;
    }
  }
  if constexpr (std::is_same<T, __nv_bfloat16>::value && N % 8 == 0) {
    if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll
      for (int i = 0; i < N / 8; ++i) {
        __nv_bfloat162 w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)   // round-to-nearest-even
          w[j] = __floats2bfloat162_rn(v[8 * i + 2 * j], v[8 * i + 2 * j + 1]);
        reinterpret_cast<uint4*>(p)[i] = *reinterpret_cast<uint4*>(w);
      }
      return;
    }
  }
#pragma unroll
  for (int n = 0; n < N; ++n) store_out(p + n, v[n]);
}

// Bc and Cc of two rounds: the one computed and the next
template <int N>
struct Stage {
  float b[2][Tile<N>::kSteps][N];
  float c[2][Tile<N>::kSteps][N];
};

// The model form's inputs of a step: dt and dt * x of the thread's channel,
// a round ahead in registers; dA and dBx formed in the thread.
template <int N, typename T>
struct ModelSrc {
  static constexpr bool kB = true;   // Bc staged beside Cc
  static constexpr int R = Tile<N>::kSteps;
  const T* dt;
  const T* x;
  int e;              // the thread's channel
  float a2[N];        // A[e] * log2(e)
  float d[R], dx[R];  // the round's dt and dt * x
  T dn[R], xn[R];     // the next round's, in flight

  // round steps t0 .. t0 + nt - 1 of (b, t) row `row` = b * S + t0
  __device__ __forceinline__ void fetch(size_t row, int nt, int E,
                                        bool live) {
    const size_t at = row * E + e;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool ok = live && r < nt;
      dn[r] = ok ? dt[at + (size_t)r * E] : T(0.f);
      xn[r] = ok ? x[at + (size_t)r * E] : T(0.f);
    }
  }
  __device__ __forceinline__ void land() {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      d[r] = to_f32(dn[r]);
      dx[r] = d[r] * to_f32(xn[r]);
    }
  }
  // step r of the round; a thread past E has dt = 0: dA = 1, dBx = 0
  __device__ __forceinline__ void step(int r, size_t, bool,
                                       const float* bt, float (&da)[N],
                                       float (&dbx)[N]) const {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      da[n] = exp2f(d[r] * a2[n]);
      dbx[n] = dx[r] * bt[n];
    }
  }
};

// The contract form's: dA and dBx rows read a step at a time.
template <int N, typename T>
struct ContractSrc {
  static constexpr bool kB = false;
  const T* dA;
  const T* dBx;
  __device__ __forceinline__ void fetch(size_t, int, int, bool) {}
  __device__ __forceinline__ void land() {}
  // ``at``: the element (b, t, e, 0) of dA / dBx
  __device__ __forceinline__ void step(int, size_t at, bool live,
                                       const float*, float (&da)[N],
                                       float (&dbx)[N]) const {
    if (live) {
      load_row<N>(dA + at, da);
      load_row<N>(dBx + at, dbx);
    } else {
#pragma unroll
      for (int n = 0; n < N; ++n) da[n] = dbx[n] = 0.f;
    }
  }
};

// The head-shared (Mamba-2) form's: one dt and one A a head.  The round's
// dt (the same address for the P threads of a head: one broadcast load)
// and x * dt are a round ahead in registers; dA is one exponential a step,
// the same for every state.
template <int N, typename T>
struct HeadSrc {
  static constexpr bool kB = true;
  static constexpr int R = Tile<N>::kSteps;
  const float* dt;    // (B, S, H)
  const T* x;         // (B, S, E)
  int e, H, hd;       // the thread's channel, the heads, its head
  float a2;           // A[hd] * log2(e)
  float d[R], dx[R];  // the round's dt and x * dt
  float dn[R];        // the next round's, in flight
  T xn[R];

  __device__ __forceinline__ void fetch(size_t row, int nt, int E,
                                        bool live) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool ok = live && r < nt;
      dn[r] = ok ? dt[(row + r) * H + hd] : 0.f;
      xn[r] = ok ? x[(row + r) * E + e] : T(0.f);
    }
  }
  __device__ __forceinline__ void land() {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      d[r] = dn[r];
      dx[r] = to_f32(xn[r]) * d[r];
    }
  }
  __device__ __forceinline__ void step(int r, size_t, bool,
                                       const float* bt, float (&da)[N],
                                       float (&dbx)[N]) const {
    const float a = exp2f(d[r] * a2);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      da[n] = a;
      dbx[n] = dx[r] * bt[n];
    }
  }
};

// Walk steps t0 .. t1 - 1 of batch row b for channel e from the state h
// (every thread of the CTA takes part: the staging and barriers are the
// CTA's); y[t] stored unless kEnds (pass 1), whose dt sum goes to *dsum.
template <int N, bool kEnds, typename Src, typename T, typename OT>
__device__ __forceinline__ void walk(Src& src, const T* bc, const T* cc,
                                     Stage<N>& st, float (&h)[N], OT* y,
                                     int b, int e, bool live, int t0, int t1,
                                     int S, int E, float* dsum) {
  constexpr int R = Tile<N>::kSteps;
  constexpr int kVals = (Src::kB ? 2 : 1) * R * N;   // staged a round
  constexpr int kPer = (kVals + kThreads - 1) / kThreads;
  const int rounds = t1 > t0 ? (t1 - t0 + R - 1) / R : 0;
  T bcn[kPer];
  // Cc (and Bc) of the round from step rt0, nt steps long
  auto fetch_bc = [&](int rt0, int nt) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int v = threadIdx.x + i * kThreads;
      const int which = v / (R * N), r = v % (R * N) / N, n = v % N;
      const T* src_ = which ? bc : cc;
      bcn[i] = v < kVals && r < nt
          ? src_[((size_t)b * S + rt0 + r) * N + n] : T(0.f);
    }
  };
  auto land_bc = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int v = threadIdx.x + i * kThreads;
      if (v >= kVals) break;
      const int which = v / (R * N), r = v % (R * N) / N, n = v % N;
      (which ? st.b : st.c)[buf][r][n] = to_f32(bcn[i]);
    }
  };
  if (rounds == 0) return;
  const size_t row0 = (size_t)b * S;   // first (b, t) row
  fetch_bc(t0, min(R, t1 - t0));
  src.fetch(row0 + t0, min(R, t1 - t0), E, live);
  land_bc(0);
  src.land();
  __syncthreads();
  for (int rd = 0; rd < rounds; ++rd) {
    const int buf = rd & 1, rt0 = t0 + rd * R, nt = min(R, t1 - rt0);
    const bool more = rd + 1 < rounds;
    if (more) {   // the next round's loads, in flight while this computes
      const int nt1 = min(R, t1 - rt0 - R);
      fetch_bc(rt0 + R, nt1);
      src.fetch(row0 + rt0 + R, nt1, E, live);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= nt) break;
      const size_t bt = row0 + rt0 + r;
      float da[N], dbx[N];
      src.step(r, (bt * E + e) * N, live, st.b[buf][r], da, dbx);
      const float* ct = st.c[buf][r];
      float yv = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        h[n] = fmaf(da[n], h[n], dbx[n]);
        yv = fmaf(h[n], ct[n], yv);
      }
      if constexpr (kEnds) {
        *dsum += src.d[r];
      } else {
        if (live) store_out(&y[bt * E + e], yv);
      }
    }
    if (more) {
      land_bc(buf ^ 1);
      src.land();
    }
    __syncthreads();   // buf is refilled after the next round
  }
}

// The model form over chunk blockIdx.z of `parts` (L = ceil(S / parts)
// steps each) for batch row blockIdx.y and kThreads channels.  kEnds (pass
// 1): from h = 0, the chunk's end state and decay into ws; else (pass 2, or
// the whole scan when parts = 1): from h0 folded through the chunks before,
// y and, in the last chunk, hT.  ws: h_end (B, parts - 1, E, N), then the
// decay, the same shape.
template <int N, typename T, typename HT, bool kEnds>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const T* __restrict__ dt, const float* __restrict__ A,
            const T* __restrict__ x, const T* __restrict__ bc,
            const T* __restrict__ cc, const HT* __restrict__ h0,
            float* __restrict__ y, float* __restrict__ hT,
            float* __restrict__ ws, int S, int E, int parts) {
  __shared__ Stage<N> st;
  const int b = blockIdx.y, c = blockIdx.z;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const bool live = e < E;
  const int L = (S + parts - 1) / parts;
  const int t0 = c * L, t1 = min(S, t0 + L);
  ModelSrc<N, T> src{dt, x, e};
  float h[N];
  if (live) {
    load_row<N>(A + (size_t)e * N, src.a2);
  } else {
#pragma unroll
    for (int n = 0; n < N; ++n) src.a2[n] = 0.f;
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    src.a2[n] *= kLog2e;
    h[n] = 0.f;
  }
  const size_t ends = (size_t)gridDim.y * (parts - 1) * E * N;
  if (!kEnds && live) {
    load_row<N>(h0 + ((size_t)b * E + e) * N, h);
    for (int j = 0; j < c; ++j) {   // the chunks before this one
      const float* he = ws + (((size_t)b * (parts - 1) + j) * E + e) * N;
      float hv[N], pv[N];
      load_row<N>(he, hv);
      load_row<N>(he + ends, pv);
#pragma unroll
      for (int n = 0; n < N; ++n) h[n] = fmaf(pv[n], h[n], hv[n]);
    }
  }
  float dsum = 0.f;
  walk<N, kEnds>(src, bc, cc, st, h, y, b, e, live, t0, t1, S, E, &dsum);
  if (!live) return;
  if constexpr (kEnds) {
    float* he = ws + (((size_t)b * (parts - 1) + c) * E + e) * N;
    float pv[N];
#pragma unroll
    for (int n = 0; n < N; ++n) pv[n] = exp2f(src.a2[n] * dsum);
    store_row<N>(he, h);
    store_row<N>(he + ends, pv);
  } else {
    if (c == parts - 1) store_row<N>(hT + ((size_t)b * E + e) * N, h);
  }
}

// A decode step (S = 1) of the model form: one step a thread.
template <int N, typename T, typename HT>
__global__ void __launch_bounds__(kThreads)
step_kernel(const T* __restrict__ dt, const float* __restrict__ A,
            const T* __restrict__ x, const T* __restrict__ bc,
            const T* __restrict__ cc, const HT* __restrict__ h0,
            float* __restrict__ y, float* __restrict__ hT, int E) {
  const int b = blockIdx.y, e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= E) return;
  const size_t at = (size_t)b * E + e;
  const float d = to_f32(dt[at]), dx = d * to_f32(x[at]);
  float h[N], a[N], bv[N], cv[N];
  load_row<N>(h0 + at * N, h);
  load_row<N>(A + (size_t)e * N, a);
  load_row<N>(bc + (size_t)b * N, bv);
  load_row<N>(cc + (size_t)b * N, cv);
  float yv = 0.f;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    h[n] = fmaf(exp2f(d * (a[n] * kLog2e)), h[n], dx * bv[n]);
    yv = fmaf(h[n], cv[n], yv);
  }
  y[at] = yv;
  store_row<N>(hT + at * N, h);
}

// The head-shared form over chunk blockIdx.z of `parts`, as scan_kernel:
// the chunk decay is one value a channel, exp2(A2[h] * sum dt).  ws: h_end
// (B, parts - 1, E, N), then the decay (B, parts - 1, E).  hT in h0's
// dtype.
template <int N, typename T, typename HT, bool kEnds>
__global__ void __launch_bounds__(kThreads)
head_scan_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                 const T* __restrict__ x, const T* __restrict__ bc,
                 const T* __restrict__ cc, const HT* __restrict__ h0,
                 float* __restrict__ y, HT* __restrict__ hT,
                 float* __restrict__ ws, int S, int E, int H, int P,
                 int parts) {
  __shared__ Stage<N> st;
  const int b = blockIdx.y, c = blockIdx.z;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const bool live = e < E;
  const int L = (S + parts - 1) / parts;
  const int t0 = c * L, t1 = min(S, t0 + L);
  HeadSrc<N, T> src{dt, x, e, H, live ? e / P : 0};
  src.a2 = live ? A[src.hd] * kLog2e : 0.f;
  float h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) h[n] = 0.f;
  const size_t ends = (size_t)gridDim.y * (parts - 1) * E;
  if (!kEnds && live) {
    load_row<N>(h0 + ((size_t)b * E + e) * N, h);
    for (int j = 0; j < c; ++j) {   // the chunks before this one
      const size_t at = ((size_t)b * (parts - 1) + j) * E + e;
      float hv[N];
      load_row<N>(ws + at * N, hv);
      const float pv = ws[ends * N + at];
#pragma unroll
      for (int n = 0; n < N; ++n) h[n] = fmaf(pv, h[n], hv[n]);
    }
  }
  float dsum = 0.f;
  walk<N, kEnds>(src, bc, cc, st, h, y, b, e, live, t0, t1, S, E, &dsum);
  if (!live) return;
  if constexpr (kEnds) {
    const size_t at = ((size_t)b * (parts - 1) + c) * E + e;
    store_row<N>(ws + at * N, h);
    ws[ends * N + at] = exp2f(src.a2 * dsum);
  } else {
    if (c == parts - 1) store_row<N>(hT + ((size_t)b * E + e) * N, h);
  }
}

// A decode step (S = 1) of the head-shared form: one step a thread, Bc and
// Cc of the row staged in shared memory once for the CTA (a thread keeps
// only its N states in registers).
template <int N, typename T, typename HT>
__global__ void __launch_bounds__(kThreads)
head_step_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                 const T* __restrict__ x, const T* __restrict__ bc,
                 const T* __restrict__ cc, const HT* __restrict__ h0,
                 float* __restrict__ y, HT* __restrict__ hT, int E, int H,
                 int P) {
  __shared__ float sb[N], sc[N];
  const int b = blockIdx.y, e = blockIdx.x * kThreads + threadIdx.x;
  for (int n = threadIdx.x; n < N; n += kThreads) {
    sb[n] = to_f32(bc[(size_t)b * N + n]);
    sc[n] = to_f32(cc[(size_t)b * N + n]);
  }
  __syncthreads();
  if (e >= E) return;
  const int hd = e / P;
  const size_t at = (size_t)b * E + e;
  const float d = dt[(size_t)b * H + hd], dx = to_f32(x[at]) * d;
  const float a = exp2f(d * (A[hd] * kLog2e));
  float h[N];
  load_row<N>(h0 + at * N, h);
  float yv = 0.f;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    h[n] = fmaf(a, h[n], dx * sb[n]);
    yv = fmaf(h[n], sc[n], yv);
  }
  y[at] = yv;
  store_row<N>(hT + at * N, h);
}

// The contract form: the whole scan, one chunk.
template <int N, typename T>
__global__ void __launch_bounds__(kThreads)
contract_kernel(const T* __restrict__ dA, const T* __restrict__ dBx,
                const T* __restrict__ cmat, const T* __restrict__ h0,
                T* __restrict__ y, T* __restrict__ hT, int S, int E) {
  __shared__ Stage<N> st;
  const int b = blockIdx.y, e = blockIdx.x * kThreads + threadIdx.x;
  const bool live = e < E;
  ContractSrc<N, T> src{dA, dBx};
  float h[N];
  if (live) {
    load_row<N>(h0 + ((size_t)b * E + e) * N, h);
  } else {
#pragma unroll
    for (int n = 0; n < N; ++n) h[n] = 0.f;
  }
  walk<N, false>(src, static_cast<const T*>(nullptr), cmat, st, h, y, b, e,
                 live, 0, S, S, E, static_cast<float*>(nullptr));
  if (live) store_row<N>(hT + ((size_t)b * E + e) * N, h);
}

template <int N, typename T, typename HT>
int launch_model(const void* dt, const void* A, const void* x, const void* bc,
                 const void* cc, const void* h0, void* y, void* hT, void* ws,
                 int B, int S, int E, int parts, cudaStream_t stream) {
  const auto* dt_ = static_cast<const T*>(dt);
  const auto* A_ = static_cast<const float*>(A);
  const auto* x_ = static_cast<const T*>(x);
  const auto* bc_ = static_cast<const T*>(bc);
  const auto* cc_ = static_cast<const T*>(cc);
  const auto* h0_ = static_cast<const HT*>(h0);
  auto* y_ = static_cast<float*>(y);
  auto* hT_ = static_cast<float*>(hT);
  auto* ws_ = static_cast<float*>(ws);
  const unsigned gx = (E + kThreads - 1) / kThreads;
  if (S == 1) {
    step_kernel<N, T, HT><<<dim3(gx, B), kThreads, 0, stream>>>(
        dt_, A_, x_, bc_, cc_, h0_, y_, hT_, E);
    return static_cast<int>(cudaGetLastError());
  }
  if (parts > 1) {
    scan_kernel<N, T, HT, true><<<dim3(gx, B, parts - 1), kThreads, 0,
                                  stream>>>(dt_, A_, x_, bc_, cc_, h0_, y_,
                                            hT_, ws_, S, E, parts);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  scan_kernel<N, T, HT, false><<<dim3(gx, B, parts), kThreads, 0, stream>>>(
      dt_, A_, x_, bc_, cc_, h0_, y_, hT_, ws_, S, E, parts);
  return static_cast<int>(cudaGetLastError());
}

template <int N, typename T, typename HT>
int launch_heads(const void* dt, const void* A, const void* x, const void* bc,
                 const void* cc, const void* h0, void* y, void* hT, void* ws,
                 int B, int S, int H, int P, int parts, cudaStream_t stream) {
  const auto* dt_ = static_cast<const float*>(dt);
  const auto* A_ = static_cast<const float*>(A);
  const auto* x_ = static_cast<const T*>(x);
  const auto* bc_ = static_cast<const T*>(bc);
  const auto* cc_ = static_cast<const T*>(cc);
  const auto* h0_ = static_cast<const HT*>(h0);
  auto* y_ = static_cast<float*>(y);
  auto* hT_ = static_cast<HT*>(hT);
  auto* ws_ = static_cast<float*>(ws);
  const int E = H * P;
  const unsigned gx = (E + kThreads - 1) / kThreads;
  if (S == 1) {
    head_step_kernel<N, T, HT><<<dim3(gx, B), kThreads, 0, stream>>>(
        dt_, A_, x_, bc_, cc_, h0_, y_, hT_, E, H, P);
    return static_cast<int>(cudaGetLastError());
  }
  if (parts > 1) {
    head_scan_kernel<N, T, HT, true><<<dim3(gx, B, parts - 1), kThreads, 0,
                                       stream>>>(
        dt_, A_, x_, bc_, cc_, h0_, y_, hT_, ws_, S, E, H, P, parts);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  head_scan_kernel<N, T, HT, false><<<dim3(gx, B, parts), kThreads, 0,
                                      stream>>>(
      dt_, A_, x_, bc_, cc_, h0_, y_, hT_, ws_, S, E, H, P, parts);
  return static_cast<int>(cudaGetLastError());
}

template <int N, typename T>
int launch_contract(const void* dA, const void* dBx, const void* cmat,
                    const void* h0, void* y, void* hT, int B, int S, int E,
                    cudaStream_t stream) {
  contract_kernel<N, T><<<dim3((E + kThreads - 1) / kThreads, B), kThreads,
                          0, stream>>>(
      static_cast<const T*>(dA), static_cast<const T*>(dBx),
      static_cast<const T*>(cmat), static_cast<const T*>(h0),
      static_cast<T*>(y), static_cast<T*>(hT), S, E);
  return static_cast<int>(cudaGetLastError());
}

// out = {registers a thread, local (spill) bytes a thread, shared memory
// bytes a CTA, CTAs resident on one SM, channels a CTA} of a scan kernel
template <typename K>
int resources(K kern, int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kern);
  if (e != cudaSuccess) return static_cast<int>(e);
  int ctas = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kern, kThreads, 0);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)attr.sharedSizeBytes;
  out[3] = ctas;
  out[4] = kThreads;
  return static_cast<int>(e);
}

// f(std::integral_constant<int, N>) for the state sizes the head-shared
// form takes
template <class F>
int with_head_state_size(int N, F&& f) {
  switch (N) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// f(std::integral_constant<int, N>) for the state sizes the other forms take
template <class F>
int with_state_size(int N, F&& f) {
  switch (N) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// f(T, HT) for the (dtype, h0 dtype) codes: 0 float32, 1 bfloat16
template <class F>
int with_types(int dtype, int h0_dtype, F&& f) {
  using bf = __nv_bfloat16;
  if (dtype == 0 && h0_dtype == 0) return f(float(), float());
  if (dtype == 0 && h0_dtype == 1) return f(float(), bf());
  if (dtype == 1 && h0_dtype == 0) return f(bf(), float());
  if (dtype == 1 && h0_dtype == 1) return f(bf(), bf());
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace mamba
}  // namespace

// dtype / h0_dtype: 0 float32, 1 bfloat16 (dt, x, Bc, Cc one dtype).  ws:
// pass 1's workspace, 2 x B x (parts - 1) x E x N floats (null where
// parts = 1); parts: 1 .. 16 time chunks, at most S (1 where S = 1).
extern "C" int mamba_scan_model(int dtype, int h0_dtype, int N,
                                const void* dt, const void* A, const void* x,
                                const void* bc, const void* cc,
                                const void* h0, void* y, void* hT, void* ws,
                                int B, int S, int E, int parts,
                                void* stream) {
  if (B < 1 || B > 65535 || S < 1 || E < 1 || parts < 1
      || parts > mamba::kMaxParts || parts > S
      || (parts > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return mamba::with_state_size(N, [&](auto n) {
    return mamba::with_types(dtype, h0_dtype, [&](auto t, auto ht) {
      return mamba::launch_model<decltype(n)::value, decltype(t),
                                 decltype(ht)>(dt, A, x, bc, cc, h0, y, hT,
                                               ws, B, S, E, parts, st);
    });
  });
}

// The model form's scan kernel for (dtype, h0_dtype, N) (launches nothing):
// out[5] = registers a thread, spill bytes a thread, shared memory bytes a
// CTA, CTAs resident on one SM, channels a CTA.
extern "C" int mamba_scan_model_resources(int dtype, int h0_dtype, int N,
                                          int* out) {
  return mamba::with_state_size(N, [&](auto n) {
    return mamba::with_types(dtype, h0_dtype, [&](auto t, auto ht) {
      return mamba::resources(
          mamba::scan_kernel<decltype(n)::value, decltype(t), decltype(ht),
                             false>, out);
    });
  });
}

// The head-shared (Mamba-2) form.  dtype / h0_dtype: 0 float32, 1 bfloat16
// (x, Bc, Cc one dtype; dt and A float32); N 16, 32 or 64; E = H * P
// channels; y float32, hT in h0's dtype.  ws: pass 1's workspace,
// B x (parts - 1) x E x (N + 1) floats (null where parts = 1); parts:
// 1 .. 16 time chunks, at most S (1 where S = 1).
extern "C" int mamba_scan_heads(int dtype, int h0_dtype, int N,
                                const void* dt, const void* A, const void* x,
                                const void* bc, const void* cc,
                                const void* h0, void* y, void* hT, void* ws,
                                int B, int S, int H, int P, int parts,
                                void* stream) {
  if (B < 1 || B > 65535 || S < 1 || H < 1 || P < 1 || parts < 1
      || parts > mamba::kMaxParts || parts > S
      || (parts > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return mamba::with_head_state_size(N, [&](auto n) {
    return mamba::with_types(dtype, h0_dtype, [&](auto t, auto ht) {
      return mamba::launch_heads<decltype(n)::value, decltype(t),
                                 decltype(ht)>(dt, A, x, bc, cc, h0, y, hT,
                                               ws, B, S, H, P, parts, st);
    });
  });
}

// The head-shared form's scan kernel (pass 2: the whole scan where parts =
// 1) for (dtype, h0_dtype, N), as mamba_scan_model_resources.
extern "C" int mamba_scan_heads_resources(int dtype, int h0_dtype, int N,
                                          int* out) {
  return mamba::with_head_state_size(N, [&](auto n) {
    return mamba::with_types(dtype, h0_dtype, [&](auto t, auto ht) {
      return mamba::resources(
          mamba::head_scan_kernel<decltype(n)::value, decltype(t),
                                  decltype(ht), false>, out);
    });
  });
}

// The head-shared form's chunked route on the tensor cores
// (ssd_scan.cuh): P 64, N 16, 32 or 64, S >= 1; dtype / h0_dtype and the
// tensors as mamba_scan_heads.  ws: pass 1's workspace, B x ceil(S / 64) x
// H x (P x N + 1) floats (the chunks' end states, then their decays);
// heads: 1 .. 8 heads a pass-1 CTA.
extern "C" int mamba_scan_heads_chunked(int dtype, int h0_dtype, int N,
                                        const void* dt, const void* A,
                                        const void* x, const void* bc,
                                        const void* cc, const void* h0,
                                        void* y, void* hT, void* ws, int B,
                                        int S, int H, int P, int heads,
                                        void* stream) {
  if (B < 1 || B > 65535 || S < 1 || H < 1 || H > 65535
      || P != mamba_ssd::kP || heads < 1 || heads > mamba_ssd::kMaxHeads
      || ws == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return mamba::with_head_state_size(N, [&](auto n) {
    return mamba::with_types(dtype, h0_dtype, [&](auto t, auto ht) {
      using T = decltype(t);
      using HT = decltype(ht);
      return static_cast<int>(mamba_ssd::launch<decltype(n)::value>(
          static_cast<const float*>(dt), static_cast<const float*>(A),
          static_cast<const T*>(x), static_cast<const T*>(bc),
          static_cast<const T*>(cc), static_cast<const HT*>(h0),
          static_cast<float*>(y), static_cast<HT*>(hT),
          static_cast<float*>(ws), B, S, H, heads, st));
    });
  });
}

// The chunked route's kernels for (dtype, h0_dtype, N): pass 1 (the
// chunks' end states), 2 (the fold over the chunks, hT) or 3 (y); out[5]
// as mamba_scan_model_resources, the last the steps (passes 1 and 3) or
// states (pass 2) a CTA.
extern "C" int mamba_scan_heads_chunked_resources(int dtype, int h0_dtype,
                                                  int N, int pass,
                                                  int* out) {
  return mamba::with_head_state_size(N, [&](auto n) {
    return mamba::with_types(dtype, h0_dtype, [&](auto t, auto ht) {
      return static_cast<int>(
          mamba_ssd::resources<decltype(n)::value, decltype(t),
                               decltype(ht)>(pass, out));
    });
  });
}

// dtype: 0 float32, 1 bfloat16 (dA, dBx, C, h0, y, hT one dtype)
extern "C" int mamba_scan_contract(int dtype, int N, const void* dA,
                                   const void* dBx, const void* cmat,
                                   const void* h0, void* y, void* hT, int B,
                                   int S, int E, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || E < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return mamba::with_state_size(N, [&](auto n) {
    if (dtype == 0)
      return mamba::launch_contract<decltype(n)::value, float>(
          dA, dBx, cmat, h0, y, hT, B, S, E, st);
    if (dtype == 1)
      return mamba::launch_contract<decltype(n)::value, __nv_bfloat16>(
          dA, dBx, cmat, h0, y, hT, B, S, E, st);
    return static_cast<int>(cudaErrorInvalidValue);
  });
}
