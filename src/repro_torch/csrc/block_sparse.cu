// Block-sparse attention for Hopper (sm_90a): K8, the attention of the DSA
// block selector (the span prefill of a GQA + DSA layer, the DSA chunks of
// training, MLA without a cache).
//
// Replaces the TPU kernel of the JAX package:
//   K8  src/repro/kernels/sparse_attention/kernel.py  block_sparse_attention
//
// Contract (the Pallas kernel's function in the model's form; see
// kernels/sparse_attention/kernel.py): q (B, S, H, DQK), k (B, T, KVH,
// DQK), v (B, T, KVH, DV), out (B, S, H, DV); query head h reads KV head
// h / G (G = H / KVH), without K/V copied G times.  block_idx (B, S/bs, nb)
// int32, shared by the heads of a batch row: query block n attends key
// block id where id >= 0 (distinct within a row); a negative id is skipped
// and stands for block -id - 1.  Query i of row b sits at q_start[b] + i,
// key j at j; a query attends the keys of its block's attended blocks with
// position <= its own and < T.  Scores are scaled (DQK^-1/2), soft-capped
// c*tanh(s/c) before masking; fp32 online softmax, masked entries count as
// NEG_INF = -1e30 in the running max and contribute p = 0.  A query that
// sees no key gets 0 (the Pallas kernel's acc / max(l, 1e-20)) or, with
// empty_mean, the mean of V over all nb * bs keys its query block lists,
// skipped blocks included (the reference's XLA function: a softmax over
// scores that are all NEG_INF is uniform).  q/k/v/out in float32 or
// bfloat16.
//
// What bounds it on this card: arithmetic.  At the Yi-6B serve span (256
// queries, H 32 / KVH 4, d 128, 16 blocks of 128 keys) it is 2*2*S*H*nb*bs*d
// = 8.6 GFLOP against ~8 MB of K/V: ~0.009 ms on the tensor cores' 989
// TFLOP/s in bf16, 0.13 ms on the CUDA cores' 67 TFLOP/s in fp32.
//
// What the design does about it:
//   * the Pallas grid is (BH, n_q_blocks, nb) with VMEM scratch across the
//     selected blocks; here one CTA per (tile of packed rows of one query
//     block, query block, KV head x batch row) walks that query block's
//     attended ids itself.  It first lists the ids that can admit a key of
//     the tile (id >= 0, block start <= the tile's last query, < T): a block
//     wholly after every query of the tile is fully masked and skipped,
//     with the same result;
//   * a tile packs the G query heads of one KV head for consecutive tokens
//     (row r = token r / G, head r % G, as K2 and K9), so each staged K/V
//     position serves every query row of the tile; the listed blocks' keys,
//     flattened (the key at flat index t is block list[t / bs], offset
//     t % bs), are staged 64 a round, so any block size works;
//   * the body is chosen by dtype.  bf16, the serving path, runs
//     mma_tile.cuh's tensor-core tile (mma.sync QK^T and PV, K/V kept bf16
//     in a cp.async ring, the flat key range split over up to 4 CTAs and
//     folded by a combine pass, so the 128 tiles of a serve span fill the
//     card; dv 256 split over two warp groups): SelectedBlocks below is its
//     layout, and its empty-row mean.  fp32, the training chunks and the
//     exact parity runs, runs block_sparse_kernel below: K/V staged in
//     shared memory as fp32, scores and P @ V on scalar FMAs, the
//     accumulator (64 rows, 32 when DQK or DV is above 128) in registers,
//     a warp a row for the softmax; a row left with no key takes a second
//     pass over the listed blocks' V for the mean.
// Not done yet (later work): the fp32 training chunk on the tensor cores
// (3xTF32 or bf16 training), wgmma and TMA for the bf16 tile.
//
// Interface: plain C, loaded with ctypes.  The entry point returns the
// cudaError_t of its launch (0 on success); it launches on the given stream,
// does not synchronise and allocates nothing.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "mma_tile.cuh"
#include "vec.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTokens = 64;        // key positions staged per round
constexpr int kMaxBlocks = 64;     // nb the kernel takes
constexpr float kNegInf = -1e30f;  // the reference kernels' NEG_INF
constexpr int kLdP = kTokens + 4;

// +4 keeps 16-byte alignment for float4 reads and spreads rows over banks
template <int D>
constexpr int kLd = D + 4;

template <int DQK, int DV, int ROWS>
constexpr size_t smem_floats() {
  return (size_t)ROWS * kLd<DQK>      // Qs
         + (size_t)kTokens * kLd<DQK>  // Ks
         + (size_t)kTokens * DV        // Vs
         + (size_t)ROWS * kLdP         // Ps
         + 3 * (size_t)ROWS;           // running max, sum, rescale
}

struct Params {
  const int* bidx;     // (B, nqb, nb)
  const int* q_start;  // (B,)
  int S, T, H, KVH, G, bs, nb, empty_mean;
  float softcap, scale;
};

// the fp32 body
template <int DQK, int DV, int ROWS>
__global__ void __launch_bounds__(kThreads)
block_sparse_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ out,
                    Params p) {
  static_assert(DQK % 32 == 0 && ROWS % 4 == 0, "tile shape");
  static_assert(DV % kThreads == 0 || kThreads % DV == 0, "column split");
  constexpr int LDK = kLd<DQK>;
  constexpr int VN = Vec<float>::N;
  constexpr int CPT = DV >= kThreads ? DV / kThreads : 1;  // columns a thread
  constexpr int RG = DV >= kThreads ? 1 : kThreads / DV;   // row groups
  constexpr int RPT = ROWS / RG;                           // rows a thread
  constexpr int KROW = DQK / VN, VROW = DV / VN;  // 16-byte vectors a row
  static_assert(kTokens * KROW % kThreads == 0 &&
                kTokens * VROW % kThreads == 0, "staging split");
  constexpr int NK = kTokens * KROW / kThreads;
  constexpr int NV = kTokens * VROW / kThreads;

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + ROWS * LDK;
  float* Vs = Ks + kTokens * LDK;
  float* Ps = Vs + kTokens * DV;
  float* Ms = Ps + ROWS * kLdP;
  float* Ls = Ms + ROWS;
  float* As = Ls + ROWS;
  __shared__ int list[kMaxBlocks];
  __shared__ int n_list;

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * ROWS;
  const int qi = blockIdx.y;
  const int kvh = blockIdx.z % p.KVH;
  const int b = blockIdx.z / p.KVH;
  const int G = p.G;
  const int rows = min(ROWS, p.bs * G - r0);
  const int tok0 = qi * p.bs;               // first query token of the block
  const int start = p.q_start[b] + tok0;    // its position
  const int q_last = start + (r0 + rows - 1) / G;
  const int* ids = p.bidx + ((size_t)b * (p.S / p.bs) + qi) * p.nb;

  // the attended blocks that can admit a key of this tile, in order
  if (tid == 0) {
    int n = 0;
    for (int j = 0; j < p.nb; ++j) {
      const int id = ids[j];
      if (id >= 0 && id * p.bs <= q_last && id * p.bs < p.T) list[n++] = id;
    }
    n_list = n;
  }
  auto q_off = [&](int r) {  // element offset of packed row r
    return ((size_t)b * p.S + tok0 + r / G) * p.H + (size_t)kvh * G + r % G;
  };
  for (int i = tid; i < rows * KROW; i += kThreads) {
    const int r = i / KROW, e = (i % KROW) * VN;
    float tmp[VN];
    Vec<float>::convert(ld16(q + q_off(r0 + r) * DQK + e), tmp);
#pragma unroll
    for (int u = 0; u < VN; ++u) Qs[r * LDK + e + u] = tmp[u];
  }
  for (int r = tid; r < ROWS; r += kThreads) {
    Ms[r] = kNegInf;
    Ls[r] = 0.f;
  }
  __syncthreads();
  const int ntok = n_list * p.bs;

  const int col0 = tid % (DV < kThreads ? DV : kThreads);
  const int rg = DV >= kThreads ? 0 : tid / DV;
  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  auto kv_off = [&](int pos) {  // row offset of key position pos
    return ((size_t)b * p.T + pos) * p.KVH + kvh;
  };
  auto key_pos = [&](int t) { return list[t / p.bs] * p.bs + t % p.bs; };

  for (int c0 = 0; c0 < ntok; c0 += kTokens) {
    const int n = min(kTokens, ntok - c0);
    __syncthreads();  // last round's readers of Ks/Vs/Ps are done
    // stage the round's keys (zeros past n or T: a masked p = 0 never meets
    // stale shared memory)
#pragma unroll
    for (int u = 0; u < NK; ++u) {
      const int i = tid + u * kThreads;
      const int t = i / KROW, e = (i % KROW) * VN;
      float kt[VN];
      const int pos = t < n ? key_pos(c0 + t) : p.T;
      if (pos < p.T) {
        Vec<float>::convert(ld16(k + kv_off(pos) * DQK + e), kt);
      } else {
#pragma unroll
        for (int w = 0; w < VN; ++w) kt[w] = 0.f;
      }
      float4* kd = reinterpret_cast<float4*>(Ks + t * LDK + e);
#pragma unroll
      for (int w = 0; w < VN / 4; ++w)
        kd[w] = make_float4(kt[4 * w], kt[4 * w + 1], kt[4 * w + 2],
                            kt[4 * w + 3]);
    }
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int i = tid + u * kThreads;
      const int t = i / VROW, e = (i % VROW) * VN;
      float vt[VN];
      const int pos = t < n ? key_pos(c0 + t) : p.T;
      if (pos < p.T) {
        Vec<float>::convert(ld16(v + kv_off(pos) * DV + e), vt);
      } else {
#pragma unroll
        for (int w = 0; w < VN; ++w) vt[w] = 0.f;
      }
      float4* vd = reinterpret_cast<float4*>(Vs + t * DV + e);
#pragma unroll
      for (int w = 0; w < VN / 4; ++w)
        vd[w] = make_float4(vt[4 * w], vt[4 * w + 1], vt[4 * w + 2],
                            vt[4 * w + 3]);
    }
    __syncthreads();

    // scores: 4 consecutive rows x 1 key a thread; -inf marks a masked entry
    for (int i = tid; i < (ROWS / 4) * kTokens; i += kThreads) {
      const int rq = (i / kTokens) * 4, t = i % kTokens;
      if (rq >= rows) break;  // i only grows along rq
      float dot[4] = {0.f, 0.f, 0.f, 0.f};
      const int kp = t < n ? key_pos(c0 + t) : p.T;
      if (kp < p.T) {
        const float4* kr = reinterpret_cast<const float4*>(Ks + t * LDK);
#pragma unroll 8
        for (int e4 = 0; e4 < DQK / 4; ++e4) {
          const float4 kv4 = kr[e4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float4 qv =
                reinterpret_cast<const float4*>(Qs + (rq + u) * LDK)[e4];
            dot[u] = fmaf(qv.x, kv4.x, dot[u]);
            dot[u] = fmaf(qv.y, kv4.y, dot[u]);
            dot[u] = fmaf(qv.z, kv4.z, dot[u]);
            dot[u] = fmaf(qv.w, kv4.w, dot[u]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int qp = start + (r0 + rq + u) / G;
        const bool ok = kp < p.T && kp <= qp;
        float s = dot[u] * p.scale;
        if (p.softcap > 0.f) s = p.softcap * tanhf(s / p.softcap);
        Ps[(rq + u) * kLdP + t] = ok ? s : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax, one warp per row
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
          const float pe = sv[j] == -INFINITY ? 0.f : expf(sv[j] - m_new);
          pr[lane + 32 * j] = pe;
          l += pe;
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

    // acc = acc * alpha + P @ V over this round's keys
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rg + i * RG;
      const float alpha = r < rows ? As[r] : 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] *= alpha;
    }
    for (int t4 = 0; t4 < n; t4 += 4) {
      float vv[4][CPT];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int j = 0; j < CPT; ++j)
          vv[u][j] = Vs[(t4 + u) * DV + col0 + j * kThreads];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float4 pp =
            reinterpret_cast<const float4*>(Ps + (rg + i * RG) * kLdP)[t4 / 4];
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          float a = acc[i][j];
          a = fmaf(pp.x, vv[0][j], a);
          a = fmaf(pp.y, vv[1][j], a);
          a = fmaf(pp.z, vv[2][j], a);
          a = fmaf(pp.w, vv[3][j], a);
          acc[i][j] = a;
        }
      }
    }
  }
  __syncthreads();

  // a row that saw no key: 0, or the mean of V over every listed block
  int empty = 0;
  for (int r = tid; r < rows; r += kThreads) empty |= Ls[r] == 0.f;
  float mean[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) mean[j] = 0.f;
  if (__syncthreads_or(empty) && p.empty_mean) {
    for (int jb = 0; jb < p.nb; ++jb) {
      const int id = ids[jb] >= 0 ? ids[jb] : -ids[jb] - 1;
      for (int t = 0; t < p.bs; ++t) {
        const int pos = min(id * p.bs + t, p.T - 1);
        const float* vr = v + kv_off(pos) * DV;
#pragma unroll
        for (int j = 0; j < CPT; ++j)
          mean[j] += vr[col0 + j * kThreads];
      }
    }
    const float inv = 1.f / (float)(p.nb * p.bs);
#pragma unroll
    for (int j = 0; j < CPT; ++j) mean[j] *= inv;
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rg + i * RG;
    if (r < rows) {
      const float l = Ls[r];
      float* o = out + q_off(r0 + r) * DV + col0;
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        store_out(o + j * kThreads,
                  l > 0.f ? acc[i][j] / l : mean[j]);
    }
  }
}

template <int DQK, int DV, int ROWS>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const Params& p, int B, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<DQK, DV, ROWS>() * sizeof(float);
  auto kern = block_sparse_kernel<DQK, DV, ROWS>;
  static bool configured = false;  // once per instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid((p.bs * p.G + ROWS - 1) / ROWS, p.S / p.bs, B * p.KVH);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), p);
  return cudaGetLastError();
}

// K8's layout on the tensor-core tile (grid y = query block, z = batch row
// x KV head): packed row r of query block y is token y*bs + r / G, head
// kvh*G + r % G; flat key t is block list[t / bs], offset t % bs, where
// list holds the attended ids that can admit a key of the tile.
struct SelectedBlocks {
  static constexpr int kList = kMaxBlocks;
  static constexpr bool kMean = true;
  const int* bidx;
  const int* q_start;
  int S, T, H, KVH, G, bs, nb, dv, empty_mean, window;
  __device__ int rows(int, int) const { return bs * G; }
  __device__ int pos0(int y, int z) const { return q_start[z / KVH] + y * bs; }
  __device__ size_t q_row(int y, int z, int r) const {
    return ((size_t)(z / KVH) * S + y * bs + r / G) * H + (z % KVH) * G
           + r % G;
  }
  __device__ size_t out_row(int y, int z, int r) const {
    return q_row(y, z, r);
  }
  __device__ const int* ids(int y, int z) const {
    return bidx + ((size_t)(z / KVH) * (S / bs) + y) * nb;
  }
  __device__ void list_keys(int y, int z, int, int q_last, int* list,
                            int* range) const {
    const int* id = ids(y, z);
    int n = 0;
    for (int j = 0; j < nb; ++j)
      if (id[j] >= 0 && id[j] * bs <= q_last && id[j] * bs < T)
        list[n++] = id[j];
    range[0] = 0;
    range[1] = n * bs - 1;
  }
  __device__ int key(int, int z, int t, const int* list, size_t& row) const {
    const int pos = list[t / bs] * bs + t % bs;
    if (pos >= T) return mma_tile::kNoKey;
    row = ((size_t)(z / KVH) * T + pos) * KVH + z % KVH;
    return pos;
  }
  // the mean of V column c over all nb * bs keys the query block lists
  __device__ float v_mean(const __nv_bfloat16* v, int y, int z,
                          int c) const {
    const int* id = ids(y, z);
    float sum = 0.f;
    for (int jb = 0; jb < nb; ++jb) {
      const int blk = id[jb] >= 0 ? id[jb] : -id[jb] - 1;
      for (int t = 0; t < bs; ++t) {
        const int pos = min(blk * bs + t, T - 1);
        sum += __bfloat162float(
            v[(((size_t)(z / KVH) * T + pos) * KVH + z % KVH) * dv + c]);
      }
    }
    return sum * (1.f / (float)(nb * bs));
  }
};

// the tensor-core body (bf16)
template <int DQK, int DV>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out,
                       void* ws, const Params& p, int B, int parts,
                       cudaStream_t stream) {
  const SelectedBlocks layout{p.bidx, p.q_start, p.S, p.T, p.H, p.KVH, p.G,
                              p.bs, p.nb, DV, p.empty_mean, 0};
  return mma_tile::launch_attention<DQK, DV>(q, k, v, out, ws, layout,
                                             p.bs * p.G, p.S / p.bs,
                                             B * p.KVH, parts, p.softcap,
                                             p.scale, stream);
}

// by dtype: fp32 the SIMT body (64 rows a CTA when both widths are <= 128,
// else 32: the register budget of the accumulator, the shared memory of the
// fp32 tiles), bf16 the tensor-core tile
template <int DQK, int DV>
cudaError_t launch_dtype(int dtype, const void* q, const void* k,
                         const void* v, void* out, void* ws, const Params& p,
                         int B, int parts, cudaStream_t s) {
  if (dtype == 0 && parts == 1)
    return launch<DQK, DV, (DQK <= 128 && DV <= 128) ? 64 : 32>(q, k, v, out,
                                                                p, B, s);
  if (dtype == 1) return launch_mma<DQK, DV>(q, k, v, out, ws, p, B, parts, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K8.  q (B, S, H, dqk); k (B, T, KVH, dqk); v (B, T, KVH, dv); out (B, S,
// H, dv); block_idx (B, S / bs, nb) int32; q_start (B,) int32; dtype: 0 =
// float32, 1 = bfloat16; empty_mean 0/1.  bf16 splits each tile's keys into
// `parts` (1..4) CTAs, with a workspace (fp32, parts > 1) of tiles x parts x
// 64 x (dv + 2) floats, tiles = ceil(bs * H / KVH / 64) * (S / bs) * B *
// KVH; fp32 takes parts = 1.
int block_sparse_attention(int dtype, int dqk, int dv, const void* q,
                           const void* k, const void* v,
                           const void* block_idx, const void* q_start,
                           void* out, int B, int S, int T, int H, int KVH,
                           int block_size, int nb, int empty_mean,
                           float softcap, float scale, int parts,
                           void* workspace, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || KVH <= 0 || H % KVH || block_size <= 0 ||
      S % block_size || nb <= 0 || nb > kMaxBlocks)
    return (int)cudaErrorInvalidValue;
  const Params p{static_cast<const int*>(block_idx),
                 static_cast<const int*>(q_start), S, T, H, KVH, H / KVH,
                 block_size, nb, empty_mean, softcap, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dqk == 64 && dv == 64)
    return (int)launch_dtype<64, 64>(dtype, q, k, v, out, workspace, p, B,
                                     parts, s);
  if (dqk == 128 && dv == 128)
    return (int)launch_dtype<128, 128>(dtype, q, k, v, out, workspace, p, B,
                                       parts, s);
  if (dqk == 192 && dv == 256)
    return (int)launch_dtype<192, 256>(dtype, q, k, v, out, workspace, p, B,
                                       parts, s);
  return (int)cudaErrorInvalidValue;
}

// Resources of K8's bf16 (tensor-core) body for (dqk, dv) (launches
// nothing): out[5] = registers a thread, spill bytes a thread, shared
// memory bytes a CTA, CTAs resident on one SM, packed query rows a CTA.
int block_sparse_resources(int dqk, int dv, int* out) {
  if (dqk == 64 && dv == 64)
    return (int)mma_tile::resources<64, 64, SelectedBlocks>(out);
  if (dqk == 128 && dv == 128)
    return (int)mma_tile::resources<128, 128, SelectedBlocks>(out);
  if (dqk == 192 && dv == 256)
    return (int)mma_tile::resources<192, 256, SelectedBlocks>(out);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
