// Mamba-1 selective scan for Hopper (sm_90a): K11.
//
// Replaces the TPU kernel of the JAX package:
//   K11  src/repro/kernels/mamba_scan/kernel.py  mamba_scan (_scan_kernel)
//
// The recurrence, for batch row b, channel e < E and state n < N, from
// h[-1] = h0, in fp32:
//   h[t][e][n] = dA[t][e][n] * h[t-1][e][n] + dBx[t][e][n]
//   y[t][e]    = sum_n h[t][e][n] * C[t][n]
// returning y (B, S, E) and the last state hT (B, E, N).  Two entry points
// share one body:
//   * mamba_scan_contract: the Pallas kernel's contract: dA and dBx
//     (B, S, E, N), C (B, S, N) and h0 (B, E, N) in one dtype (float32 or
//     bfloat16); y and hT in that dtype;
//   * mamba_scan_model: the tensors the model has (layers/ssm.py,
//     apply_mamba1): dt and x (B, S, E), Bc and Cc (B, S, N) in the model's
//     dtype (float32 or bfloat16), A (E, N) float32 and h0 (B, E, N) float32
//     or bfloat16; it discretizes itself, dA = expf(dt * A[e][n]) and
//     dBx = (dt * x) * Bc[n], the reference's order of products, so the
//     (B, S, E, N) dA and dBx (1 MiB a token a layer at falcon-mamba's
//     E 8192, N 16) never reach device memory; y and hT in float32.
// expf, not __expf: the build has no fast math.
//
// What bounds it on this card: at falcon-mamba's serve prefill (B 8, S 1024,
// E 8192, N 16, bf16) the model form moves dt, x (bf16) and y (fp32), ~0.54
// GB, 0.16 ms at 3.35 TB/s; it also takes B*S*E*N = 1.07 G expf, which the
// special-function units issue at 16 a clock an SM (~0.26 ms on 132 SMs at
// 1.98 GHz), and the sequential time walk: each step of a lane is a
// dependent chain of an expf, two FMAs and log2(N) shuffles.  That chain
// sets this version's time (1.51 ms there on an H100 80GB HBM3 at 700 W,
// chip_smoke.py's timing phase).  A decode step (S 1) reads h0 and writes
// hT: launch latency dominates.
//
// What the design does about it:
//   * the Pallas grid is (B, E / 512), each program a (512, N) fp32 state
//     tile in VMEM walking time; here a lane owns one (channel, state) pair,
//     its h in a register, so a warp holds 32 / N whole channels and a CTA
//     of 256 threads 256 / N channels of one batch row; the grid is
//     (ceil(E / (256 / N)), B), so B*E*N lanes fill the card even at batch 1
//     (a thread per channel would leave most SMs idle at the training shape);
//   * y[t][e] is a __shfl_xor_sync butterfly over the N lanes of a channel;
//   * each round stages TT time steps of the CTA's channels in shared memory
//     with coalesced loads (model form: dt and dt * x a channel, Bc and Cc a
//     state; contract form: C), so a step's own chain reads only shared
//     memory (the contract form reads its dA and dBx straight from device
//     memory: consecutive lanes hold consecutive (e, n), so each step's
//     loads are coalesced); the round's y are staged too and written out as
//     rows of the CTA's channels;
//   * ragged E is masked (a lane past E holds h = 0 and stores nothing);
//     the last round of a ragged S is short.
// Not done yet (later work): a chunked parallel scan over time, fewer
// shuffles a step (a transposed reduction over N steps at once), a backward
// kernel (the backward is plain PyTorch, kernels/mamba_scan/ref.py).
//
// Interface: plain C, loaded with ctypes.  The entry points return the
// cudaError_t of their launch (0 on success); they launch on the given
// stream, do not synchronise and allocate nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include <type_traits>

#include "vec.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// CE channels a CTA (a lane per (channel, state)), TT time steps a round
template <int N>
struct Tile {
  static constexpr int CE = THREADS / N;
  static constexpr int TT =
      1024 / CE < 8 ? 8 : (1024 / CE > 32 ? 32 : 1024 / CE);
};

// The model form's source of a step: dt and dt * x a channel, Bc and Cc a
// state, staged; dA and dBx computed in the lane.
template <int N, typename T>
struct ModelSrc {
  static constexpr int CE = Tile<N>::CE, TT = Tile<N>::TT;
  struct Shared {
    float dt[TT][CE];
    float dtx[TT][CE];
    float b[TT][N];
    float c[TT][N];
    float y[TT][CE];
  };
  const T* dt;
  const T* x;
  const T* bc;
  const T* cc;
  float a;  // A[e][n] of this lane

  __device__ void stage(Shared& s, int b, int t0, int nt, int e0, int S,
                        int E) const {
    for (int i = threadIdx.x; i < TT * CE; i += THREADS) {
      const int r = i / CE, c = i % CE;
      float d = 0.f, xv = 0.f;
      if (r < nt && e0 + c < E) {
        const size_t at = ((size_t)b * S + t0 + r) * E + e0 + c;
        d = to_f32(dt[at]);
        xv = to_f32(x[at]);
      }
      s.dt[r][c] = d;
      s.dtx[r][c] = d * xv;
    }
    for (int i = threadIdx.x; i < TT * N; i += THREADS) {
      const int r = i / N, n = i % N;
      float bv = 0.f, cv = 0.f;
      if (r < nt) {
        const size_t at = ((size_t)b * S + t0 + r) * N + n;
        bv = to_f32(bc[at]);
        cv = to_f32(cc[at]);
      }
      s.b[r][n] = bv;
      s.c[r][n] = cv;
    }
  }

  // dA and dBx of step r of the round (a lane past E: dt = 0, so dA = 1
  // and dBx = 0, and its h stays 0)
  __device__ void step(const Shared& s, int r, int c, int n, size_t,
                       float& da, float& dbx) const {
    da = expf(s.dt[r][c] * a);
    dbx = s.dtx[r][c] * s.b[r][n];
  }
};

// The contract form's source: C staged, dA and dBx read in the lane.
template <int N, typename T>
struct ContractSrc {
  static constexpr int CE = Tile<N>::CE, TT = Tile<N>::TT;
  struct Shared {
    float c[TT][N];
    float y[TT][CE];
  };
  const T* dA;
  const T* dBx;
  const T* cmat;
  bool live;

  __device__ void stage(Shared& s, int b, int t0, int nt, int, int S,
                        int) const {
    for (int i = threadIdx.x; i < TT * N; i += THREADS) {
      const int r = i / N, n = i % N;
      s.c[r][n] = r < nt ? to_f32(cmat[((size_t)b * S + t0 + r) * N + n])
                         : 0.f;
    }
  }

  // ``at``: the element (b, t, e, n) of dA / dBx this lane reads
  __device__ void step(const Shared&, int, int, int, size_t at, float& da,
                       float& dbx) const {
    da = live ? to_f32(dA[at]) : 0.f;
    dbx = live ? to_f32(dBx[at]) : 0.f;
  }
};

// One CTA: batch row blockIdx.y, channels [e0, e0 + CE); thread i holds
// channel e0 + i / N, state i % N.
template <int N, class Src, typename HT, typename OutT>
__device__ void scan_body(const Src& src, typename Src::Shared& s,
                          const HT* h0, OutT* y, OutT* hT, int S, int E) {
  constexpr int CE = Src::CE, TT = Src::TT;
  const int b = blockIdx.y, e0 = blockIdx.x * CE;
  const int c = threadIdx.x / N, n = threadIdx.x % N;
  const int e = e0 + c;
  const bool live = e < E;
  const size_t hs = ((size_t)b * E + e) * N + n;
  float h = live ? to_f32(h0[hs]) : 0.f;
  for (int t0 = 0; t0 < S; t0 += TT) {
    const int nt = min(TT, S - t0);
    __syncthreads();  // the last round's y tile is written out
    src.stage(s, b, t0, nt, e0, S, E);
    __syncthreads();
    for (int r = 0; r < nt; ++r) {
      float da, dbx;
      src.step(s, r, c, n, (((size_t)b * S + t0 + r) * E + e) * N + n, da,
               dbx);
      h = da * h + dbx;
      float v = h * s.c[r][n];
#pragma unroll
      for (int off = N / 2; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (n == 0) s.y[r][c] = v;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nt * CE; i += THREADS) {
      const int r = i / CE, cc = i % CE;
      if (e0 + cc < E)
        store_out(&y[((size_t)b * S + t0 + r) * E + e0 + cc], s.y[r][cc]);
    }
  }
  if (live) store_out(&hT[hs], h);
}

template <int N, typename T, typename HT>
__global__ void __launch_bounds__(THREADS)
    mamba_scan_model_kernel(const T* dt, const float* A, const T* x,
                            const T* bc, const T* cc, const HT* h0, float* y,
                            float* hT, int S, int E) {
  using Src = ModelSrc<N, T>;
  __shared__ typename Src::Shared s;
  const int e = blockIdx.x * Src::CE + threadIdx.x / N;
  const float a = e < E ? A[(size_t)e * N + threadIdx.x % N] : 0.f;
  const Src src{dt, x, bc, cc, a};
  scan_body<N>(src, s, h0, y, hT, S, E);
}

template <int N, typename T>
__global__ void __launch_bounds__(THREADS)
    mamba_scan_contract_kernel(const T* dA, const T* dBx, const T* cmat,
                               const T* h0, T* y, T* hT, int S, int E) {
  using Src = ContractSrc<N, T>;
  __shared__ typename Src::Shared s;
  const int e = blockIdx.x * Src::CE + threadIdx.x / N;
  const Src src{dA, dBx, cmat, e < E};
  scan_body<N>(src, s, h0, y, hT, S, E);
}

template <int N>
dim3 grid(int B, int E) {
  return dim3((E + Tile<N>::CE - 1) / Tile<N>::CE, B);
}

template <int N, typename T, typename HT>
int launch_model(const void* dt, const void* A, const void* x, const void* bc,
                 const void* cc, const void* h0, void* y, void* hT, int B,
                 int S, int E, cudaStream_t stream) {
  mamba_scan_model_kernel<N, T, HT><<<grid<N>(B, E), THREADS, 0, stream>>>(
      static_cast<const T*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(x), static_cast<const T*>(bc),
      static_cast<const T*>(cc), static_cast<const HT*>(h0),
      static_cast<float*>(y), static_cast<float*>(hT), S, E);
  return static_cast<int>(cudaGetLastError());
}

template <int N, typename T>
int launch_contract(const void* dA, const void* dBx, const void* cmat,
                    const void* h0, void* y, void* hT, int B, int S, int E,
                    cudaStream_t stream) {
  mamba_scan_contract_kernel<N, T><<<grid<N>(B, E), THREADS, 0, stream>>>(
      static_cast<const T*>(dA), static_cast<const T*>(dBx),
      static_cast<const T*>(cmat), static_cast<const T*>(h0),
      static_cast<T*>(y), static_cast<T*>(hT), S, E);
  return static_cast<int>(cudaGetLastError());
}

// f(std::integral_constant<int, N>) for the state sizes the kernels take
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

template <typename T, typename HT>
int model_n(int N, const void* dt, const void* A, const void* x,
            const void* bc, const void* cc, const void* h0, void* y, void* hT,
            int B, int S, int E, cudaStream_t st) {
  return with_state_size(N, [&](auto n) {
    return launch_model<decltype(n)::value, T, HT>(dt, A, x, bc, cc, h0, y,
                                                    hT, B, S, E, st);
  });
}

template <typename T>
int contract_n(int N, const void* dA, const void* dBx, const void* cmat,
               const void* h0, void* y, void* hT, int B, int S, int E,
               cudaStream_t st) {
  return with_state_size(N, [&](auto n) {
    return launch_contract<decltype(n)::value, T>(dA, dBx, cmat, h0, y, hT,
                                                  B, S, E, st);
  });
}

}  // namespace

// dtype / h0_dtype: 0 float32, 1 bfloat16 (dt, x, Bc, Cc one dtype)
extern "C" int mamba_scan_model(int dtype, int h0_dtype, int N,
                                const void* dt, const void* A, const void* x,
                                const void* bc, const void* cc,
                                const void* h0, void* y, void* hT, int B,
                                int S, int E, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && h0_dtype == 0)
    return model_n<float, float>(N, dt, A, x, bc, cc, h0, y, hT, B, S, E, st);
  if (dtype == 0 && h0_dtype == 1)
    return model_n<float, __nv_bfloat16>(N, dt, A, x, bc, cc, h0, y, hT, B, S,
                                         E, st);
  if (dtype == 1 && h0_dtype == 0)
    return model_n<__nv_bfloat16, float>(N, dt, A, x, bc, cc, h0, y, hT, B, S,
                                         E, st);
  if (dtype == 1 && h0_dtype == 1)
    return model_n<__nv_bfloat16, __nv_bfloat16>(N, dt, A, x, bc, cc, h0, y,
                                                 hT, B, S, E, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dtype: 0 float32, 1 bfloat16 (dA, dBx, C, h0, y, hT one dtype)
extern "C" int mamba_scan_contract(int dtype, int N, const void* dA,
                                   const void* dBx, const void* cmat,
                                   const void* h0, void* y, void* hT, int B,
                                   int S, int E, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return contract_n<float>(N, dA, dBx, cmat, h0, y, hT, B, S, E, st);
  if (dtype == 1)
    return contract_n<__nv_bfloat16>(N, dA, dBx, cmat, h0, y, hT, B, S, E,
                                     st);
  return static_cast<int>(cudaErrorInvalidValue);
}
