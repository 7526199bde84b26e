// Paged absorbed-MLA attention for Hopper (sm_90a): K3 decode and K4 span
// prefill, both reading the latent pools IN PLACE through the block table.
//
// Replaces the TPU kernels of the JAX package:
//   K3  src/repro/kernels/paged_attention/kernel.py   paged_decode_mla
//   K4  src/repro/kernels/paged_attention/prefill.py  paged_prefill_mla
//
// Contract (the same as the Pallas kernels): token position p of row b lives
// at (tables[b, p / bs], p % bs) of c_pool (nb, bs, lora) and kr_pool
// (nb, bs, rope).  Packed query row r of batch row b is head h = r % H of
// span token i = r / H at absolute position starts[b] + i (decode: S = 1 and
// starts = seq_lens).  All heads share the one latent KV.  A query attends
// every position k_pos <= q_pos with score
//   s = (q_lat . c + q_rope . kr) * scale     (scale = (qk_nope+qk_rope)^-1/2)
// folded with an fp32 online softmax, and the output is probs . c: the
// latent is also the value.  q_lat and the output are fp32 (the absorbed
// query q_nope . W^UK is built in fp32); q_rope and the pools are in the
// model's dtype.  The final division clamps l at 1e-20 so a trash row
// (length 0) still gives a finite output.
//
// What bounds it on this card: per query row and key it does
// 2*(lora+rope) + 2*lora = 2176 flops (GLM-5: lora 512, rope 64) against
// 1152 bytes of bf16 latent shared by all H heads, so at H = 64 a decode
// step does ~120 flops per latent byte.  That is below the ~295 flop/byte
// ridge of the tensor cores (so the bound below is the latent bytes for
// decode and the operations for long spans), but far above what CUDA cores
// in fp32 sustain per byte: this kernel, which runs on CUDA cores, is
// bound by its fp32 arithmetic and shared-memory traffic.
//
// What the design does:
//   * one CTA per (16-row tile, batch row) walks only that tile's live
//     blocks itself: it loads its own table entries and start and stops at
//     the block of its last query position (causal early exit per tile), so
//     traffic is O(live tokens) and nothing is gathered into a padded view;
//   * a round stages 32 positions of [c | kr] in shared memory as fp32; the
//     same staged c serves the scores and the PV product, so each latent
//     byte is read from device memory once per tile; every load of a round
//     is issued before any is used and, for bf16, the next round's loads are
//     in flight while this round computes;
//   * the Pallas kernels keep the whole (H, lora) or (S*H, lora) fp32
//     accumulator in VMEM (128 KB per decode row, 32 MB for a 256-token
//     span at H = 64); here the packed rows are tiled 16 at a time and the
//     16 x lora accumulator lives in registers, each thread owning lora/256
//     columns of every row;
//   * scores: warp w owns rows 2w and 2w+1 and lane t position t of the
//     round, so the warp holds whole score rows and runs their online
//     softmax in registers with shuffles, without another barrier.
// Not done yet (later work): tensor cores (mma/wgmma, bf16 in, fp32
// accumulate), split-KV with a combine pass (decode at B = 8, H = 64
// launches only 32 CTAs on 132 SMs), TMA.
//
// Interface: plain C, loaded with ctypes.  Each entry point returns the
// cudaError_t of its launch (0 on success); it launches on the given stream,
// does not synchronise and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 2 * kWarps;  // packed query rows per CTA (2 per warp)
constexpr int kTokens = 32;        // latent positions per round (1 per lane)
constexpr int kLdP = kTokens + 4;  // probability row stride (floats)
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

// Shared-memory row stride (floats) of the staged [q_lat | q_rope] rows and
// [c | kr] positions.  +4 keeps 16-byte alignment for the float4 reads and
// puts the 8 rows a quarter-warp reads on distinct banks.
template <int L, int R>
constexpr int kLd = L + R + 4;

template <int L, int R>
constexpr size_t smem_floats() {
  return (size_t)kRows * kLd<L, R>       // Qs
         + (size_t)kTokens * kLd<L, R>   // Ks: [c | kr] per position
         + (size_t)kRows * kLdP          // Ps
         + 3 * (size_t)kRows;            // running max, sum, rescale
}

template <typename T, int L, int R>
__global__ void __launch_bounds__(kThreads)
paged_mla_kernel(const float* __restrict__ q_lat,
                 const T* __restrict__ q_rope, const T* __restrict__ c_pool,
                 const T* __restrict__ kr_pool,
                 const int* __restrict__ tables,
                 const int* __restrict__ starts, float* __restrict__ out,
                 int SH, int H, int mb, int bs, float scale) {
  constexpr int D = L + R;           // length of a score's dot product
  constexpr int LD = kLd<L, R>;
  constexpr int VN = Vec<T>::N;
  static_assert(L % VN == 0 && R % VN == 0, "vector width");
  constexpr int VL = L / VN;         // 16-byte vectors of c per position
  constexpr int VPK = D / VN;        // ... of [c | kr] per position
  static_assert(kTokens * VPK % kThreads == 0, "staging split");
  constexpr int NV = kTokens * VPK / kThreads;  // per thread and round
  static_assert(L % kThreads == 0, "columns per thread");
  constexpr int CPT = L / kThreads;
  static_assert(kTokens == 32, "one position per lane");
  // the next round's latent waits in registers while this round computes,
  // where the accumulator leaves room (bf16)
  constexpr bool kPrefetch = NV * 4 + kRows * CPT <= 80;

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kRows * LD;
  float* Ps = Ks + kTokens * LD;
  float* Ms = Ps + kRows * kLdP;
  float* Ls = Ms + kRows;
  float* As = Ls + kRows;

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int r0 = blockIdx.x * kRows;
  const int b = blockIdx.y;
  const int rows = min(kRows, SH - r0);
  const int start = starts[b];
  const int* table = tables + (size_t)b * mb;
  const size_t row0 = (size_t)b * SH + r0;  // packed row index

  // stage the tile's queries [q_lat | q_rope] as fp32; rows past `rows`
  // are zero and masked, so they fold nothing and are never written
  for (int i = tid; i < kRows * (L / 4); i += kThreads) {
    const int r = i / (L / 4), e = (i % (L / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows)
      v = *reinterpret_cast<const float4*>(q_lat + (row0 + r) * L + e);
    *reinterpret_cast<float4*>(Qs + r * LD + e) = v;
  }
  for (int i = tid; i < kRows * (R / VN); i += kThreads) {
    const int r = i / (R / VN), e = (i % (R / VN)) * VN;
    float tmp[VN];
    if (r < rows) {
      Vec<T>::convert(ld16(q_rope + (row0 + r) * R + e), tmp);
    } else {
#pragma unroll
      for (int u = 0; u < VN; ++u) tmp[u] = 0.f;
    }
#pragma unroll
    for (int u = 0; u < VN; ++u) Qs[r * LD + L + e + u] = tmp[u];
  }
  for (int r = tid; r < kRows; r += kThreads) {
    Ms[r] = kNegInf;
    Ls[r] = 0.f;
  }

  float acc[kRows][CPT];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  // live range of the tile: position 0 .. the tile's last query position
  const int hi = min(start + (r0 + rows - 1) / H, mb * bs - 1);
  // this warp's two score rows and their positions
  const int ra = 2 * warp, rb = ra + 1;
  const int qpa = start + (r0 + ra) / H, qpb = start + (r0 + rb) / H;

  // every load of the round at c0 is issued before any is used; past hi a
  // thread stages zeros, so the p = 0 padding of a short round never meets
  // stale shared memory
  uint4 raw[NV];
  auto fetch = [&](int c0) {
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int i = tid + u * kThreads;
      const int t = i / VPK, v = i % VPK;
      const int pos = c0 + t;
      if (pos <= hi) {
        const size_t slot = (size_t)table[pos / bs] * bs + pos % bs;
        raw[u] = v < VL ? ld16(c_pool + slot * L + v * VN)
                        : ld16(kr_pool + slot * R + (v - VL) * VN);
      } else {
        raw[u] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };
  // [c | kr] of position t lands at Ks[t*LD .. t*LD + D): vector v of the
  // position goes to offset v*VN whether it came from c or from kr
  auto stash = [&]() {
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int i = tid + u * kThreads;
      const int t = i / VPK, v = i % VPK;
      float tmp[VN];
      Vec<T>::convert(raw[u], tmp);
      float4* dst = reinterpret_cast<float4*>(Ks + t * LD + v * VN);
#pragma unroll
      for (int w = 0; w < VN / 4; ++w)
        dst[w] = make_float4(tmp[4 * w], tmp[4 * w + 1], tmp[4 * w + 2],
                             tmp[4 * w + 3]);
    }
  };
  // one score row of the warp through the online softmax (the reference's
  // update: masked entries count as NEG_INF in the max and contribute 0)
  auto fold_row = [&](int r, float s, bool ok) {
    float mx = ok ? s : -INFINITY;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_prev = Ms[r];
    const float m_new = fmaxf(m_prev, mx);
    const float p = ok ? expf(s - m_new) : 0.f;
    float l = p;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, o);
    Ps[r * kLdP + lane] = p;
    if (lane == 0) {  // every lane read Ms[r] before the shuffles above
      const float alpha = expf(m_prev - m_new);
      Ls[r] = Ls[r] * alpha + l;
      Ms[r] = m_new;
      As[r] = alpha;
    }
  };

  if constexpr (kPrefetch) fetch(0);
  for (int c0 = 0; c0 <= hi; c0 += kTokens) {
    const int n = min(kTokens, hi - c0 + 1);
    if constexpr (!kPrefetch) fetch(c0);
    __syncthreads();  // last round's readers of Ks/Ps/As are done
    stash();
    if constexpr (kPrefetch) {
      if (c0 + kTokens <= hi) fetch(c0 + kTokens);  // lands during compute
    }
    __syncthreads();

    // scores of rows ra, rb against position `lane` of the round: the
    // query rows are broadcast, the position rows conflict-free
    {
      const float4* kv = reinterpret_cast<const float4*>(Ks + lane * LD);
      const float4* qa = reinterpret_cast<const float4*>(Qs + ra * LD);
      const float4* qb = reinterpret_cast<const float4*>(Qs + rb * LD);
      float da = 0.f, db = 0.f;
#pragma unroll 8
      for (int e4 = 0; e4 < D / 4; ++e4) {
        const float4 k = kv[e4];
        const float4 x = qa[e4];
        const float4 y = qb[e4];
        da = fmaf(x.x, k.x, da);
        da = fmaf(x.y, k.y, da);
        da = fmaf(x.z, k.z, da);
        da = fmaf(x.w, k.w, da);
        db = fmaf(y.x, k.x, db);
        db = fmaf(y.y, k.y, db);
        db = fmaf(y.z, k.z, db);
        db = fmaf(y.w, k.w, db);
      }
      const int kp = c0 + lane;
      const bool live = lane < n;
      fold_row(ra, da * scale, live && ra < rows && kp <= qpa);
      fold_row(rb, db * scale, live && rb < rows && kp <= qpb);
    }
    __syncthreads();

    // acc = acc * alpha + P @ C over this round's positions (the staged c
    // is the value)
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float alpha = As[i];
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] *= alpha;
    }
    for (int t4 = 0; t4 < n; t4 += 4) {
      float v[4][CPT];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int j = 0; j < CPT; ++j)
          v[u][j] = Ks[(t4 + u) * LD + tid + j * kThreads];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 p = reinterpret_cast<const float4*>(Ps + i * kLdP)[t4 / 4];
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
  for (int i = 0; i < kRows; ++i) {
    if (i < rows) {
      const float l = fmaxf(Ls[i], 1e-20f);
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        out[(row0 + i) * L + tid + j * kThreads] = acc[i][j] / l;
    }
  }
}

struct Args {
  const float* q_lat;
  const void* q_rope;
  const void* c_pool;
  const void* kr_pool;
  const int* tables;
  const int* starts;
  float* out;
  int B, SH, H, mb, bs;
  float scale;
};

// Lets the instantiation use its dynamic shared memory (over the 48 KB
// default); once per instantiation.
template <typename T, int L, int R>
cudaError_t configure() {
  static bool configured = false;
  if (configured) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      paged_mla_kernel<T, L, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(smem_floats<L, R>() * sizeof(float)));
  configured = e == cudaSuccess;
  return e;
}

template <typename T, int L, int R>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<L, R>() * sizeof(float);
  auto kern = paged_mla_kernel<T, L, R>;
  cudaError_t e = configure<T, L, R>();
  if (e != cudaSuccess) return e;
  dim3 grid((a.SH + kRows - 1) / kRows, a.B);
  kern<<<grid, kThreads, smem, stream>>>(
      a.q_lat, static_cast<const T*>(a.q_rope),
      static_cast<const T*>(a.c_pool), static_cast<const T*>(a.kr_pool),
      a.tables, a.starts, a.out, a.SH, a.H, a.mb, a.bs, a.scale);
  return cudaGetLastError();
}

int run(int dtype, int lora, int rope, const Args& a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.bs != 8 && a.bs != 16 && a.bs != 32) return (int)cudaErrorInvalidValue;
  if (lora != 512 || rope != 64) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)launch<float, 512, 64>(a, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16, 512, 64>(a, s);
  return (int)cudaErrorInvalidValue;
}

// out = {registers a thread, local (spill) bytes a thread, dynamic shared
// memory bytes a CTA, CTAs resident on one SM (as the runtime reports
// them), packed query rows a CTA}
template <typename T, int L, int R>
cudaError_t query(int* out) {
  constexpr size_t smem = smem_floats<L, R>() * sizeof(float);
  auto kern = paged_mla_kernel<T, L, R>;
  cudaError_t e = configure<T, L, R>();
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kern);
  if (e != cudaSuccess) return e;
  int ctas = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kern, kThreads,
                                                    smem);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)smem;
  out[3] = ctas;
  out[4] = kRows;
  return e;
}

}  // namespace

extern "C" {

// K3.  q_lat (B, H, lora) float32; q_rope (B, H, rope); pools c (nb, bs,
// lora), kr (nb, bs, rope); tables (B, mb) int32; seq_lens (B,) int32 (the
// query's position); out (B, H, lora) float32.
// dtype of q_rope and the pools: 0 = float32, 1 = bfloat16.
int paged_decode_mla(int dtype, int lora, int rope, int block_size,
                     const float* q_lat, const void* q_rope,
                     const void* c_pool, const void* kr_pool,
                     const int* tables, const int* seq_lens, float* out,
                     int B, int H, int mb, float scale, void* stream) {
  Args a{q_lat, q_rope, c_pool, kr_pool, tables, seq_lens, out,
         B, H, H, mb, block_size, scale};
  return run(dtype, lora, rope, a, stream);
}

// K4.  q_lat (B, S*H, lora) packed rows i*H + h; q_rope (B, S*H, rope);
// starts (B,) int32 (position of span token 0); out (B, S*H, lora) float32.
int paged_prefill_mla(int dtype, int lora, int rope, int block_size,
                      const float* q_lat, const void* q_rope,
                      const void* c_pool, const void* kr_pool,
                      const int* tables, const int* starts, float* out,
                      int B, int SH, int H, int mb, float scale,
                      void* stream) {
  Args a{q_lat, q_rope, c_pool, kr_pool, tables, starts, out,
         B, SH, H, mb, block_size, scale};
  return run(dtype, lora, rope, a, stream);
}

// Resources of the K3/K4 kernel for `dtype` (launches nothing): out[5] =
// registers a thread, spill bytes a thread, shared memory bytes a CTA, CTAs
// resident on one SM, packed query rows a CTA.
int paged_mla_resources(int dtype, int lora, int rope, int* out) {
  if (lora != 512 || rope != 64) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)query<float, 512, 64>(out);
  if (dtype == 1) return (int)query<__nv_bfloat16, 512, 64>(out);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
