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
// What bounds it on this card: arithmetic.  At the Yi-6B serve span and
// training chunk (256 queries, H 32 / KVH 4, d 128, 16 blocks of 128 keys)
// it is 2*2*S*H*nb*bs*d = 8.6 GFLOP against ~10 MB of q/out and K/V:
// ~0.009 ms on the tensor cores' 989 TFLOP/s in bf16; in fp32, with TF32
// off, 0.13 ms on the CUDA cores' 67 TFLOP/s, or 0.052 ms as three TF32
// products at 495 TFLOP/s.
//
// What the design does about it:
//   * the Pallas grid is (BH, n_q_blocks, nb) with VMEM scratch across the
//     selected blocks; here one CTA per (tile of 64 packed rows of one
//     query block, query block, KV head x batch row) walks that query
//     block's attended ids itself.  It first lists the ids that can admit
//     a key of the tile (id >= 0, block start <= the tile's last query,
//     < T): a block wholly after every query of the tile is fully masked
//     and skipped, with the same result;
//   * a tile packs the G query heads of one KV head for consecutive tokens
//     (row r = token r / G, head r % G, as K2 and K9), so each staged K/V
//     position serves every query row of the tile; the listed blocks' keys,
//     flattened (the key at flat index t is block list[t / bs], offset
//     t % bs), are staged a round at a time in a cp.async ring, so any
//     block size works; the flat key range is split over up to 4 CTAs
//     when the tiles leave CTA slots of the card empty, and a combine pass
//     folds the parts;
//   * the body is chosen by dtype, both on the tensor cores with one layout
//     (SelectedBlocks below, with its empty-row mean).  bf16, the serving
//     path, runs mma_tile.cuh's tile (mma.sync m16n8k16, P rounded to bf16
//     for PV).  fp32, the training chunks and the exact parity runs, runs
//     tf32_tile.cuh's 3xTF32 tile (mma.sync m16n8k8 on TF32 values, each
//     fp32 operand split into big + small and three products summed in
//     fp32: fp32-level error with TF32 off), at every (dqk, dv) the kernel
//     takes: (192, 256) with 32 keys a round and one CTA an SM (170 KB of
//     shared memory).
// Not done yet (later work): wgmma and TMA for both tiles.
//
// Interface: plain C, loaded with ctypes.  The entry point returns the
// cudaError_t of its launch (0 on success); it launches on the given stream,
// does not synchronise and allocates nothing.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "mma_tile.cuh"
#include "tf32_tile.cuh"

namespace {

constexpr int kMaxBlocks = 64;     // nb the kernel takes

struct Params {
  const int* bidx;     // (B, nqb, nb)
  const int* q_start;  // (B,)
  int S, T, H, KVH, G, bs, nb, empty_mean;
  float softcap, scale;
};

__device__ inline float to_float(float x) { return x; }
__device__ inline float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// K8's layout on both tensor-core tiles (grid y = query block, z = batch
// row x KV head): packed row r of query block y is token y*bs + r / G, head
// kvh*G + r % G; flat key t is block list[t / bs], offset t % bs, where
// list holds the attended ids that can admit a key of the tile; causal.
struct SelectedBlocks {
  static constexpr int kList = kMaxBlocks;
  static constexpr bool kMean = true;
  const int* bidx;
  const int* q_start;
  int S, T, H, KVH, G, bs, nb, dv, empty_mean, window;
  __device__ bool causal() const { return true; }
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
  // (bf16 V: the mma_tile route; fp32: the tf32_tile route)
  template <typename TV>
  __device__ float v_mean(const TV* v, int y, int z, int c) const {
    const int* id = ids(y, z);
    float sum = 0.f;
    for (int jb = 0; jb < nb; ++jb) {
      const int blk = id[jb] >= 0 ? id[jb] : -id[jb] - 1;
      for (int t = 0; t < bs; ++t) {
        const int pos = min(blk * bs + t, T - 1);
        sum += to_float(
            v[(((size_t)(z / KVH) * T + pos) * KVH + z % KVH) * dv + c]);
      }
    }
    return sum * (1.f / (float)(nb * bs));
  }
};

// by dtype: fp32 the 3xTF32 tile, bf16 the bf16 tile; both split each
// tile's keys into `parts` CTAs and fold them
template <int DQK, int DV>
cudaError_t launch_dtype(int dtype, const void* q, const void* k,
                         const void* v, void* out, void* ws, const Params& p,
                         int B, int parts, cudaStream_t s) {
  const SelectedBlocks layout{p.bidx, p.q_start, p.S, p.T, p.H, p.KVH, p.G,
                              p.bs, p.nb, DV, p.empty_mean, 0};
  const int rows = p.bs * p.G, ny = p.S / p.bs, nz = B * p.KVH;
  if (dtype == 0)
    return tf32_tile::launch_attention<DQK, DV>(q, k, v, out, ws, layout,
                                                rows, ny, nz, parts,
                                                p.softcap, p.scale, s);
  if (dtype == 1)
    return mma_tile::launch_attention<DQK, DV>(q, k, v, out, ws, layout,
                                               rows, ny, nz, parts, p.softcap,
                                               p.scale, s);
  return cudaErrorInvalidValue;
}

template <int DQK, int DV>
cudaError_t query(int dtype, int* out) {
  if (dtype == 0) return tf32_tile::resources<DQK, DV, SelectedBlocks>(out);
  if (dtype == 1) return mma_tile::resources<DQK, DV, SelectedBlocks>(out);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K8.  q (B, S, H, dqk); k (B, T, KVH, dqk); v (B, T, KVH, dv); out (B, S,
// H, dv); block_idx (B, S / bs, nb) int32; q_start (B,) int32; dtype: 0 =
// float32, 1 = bfloat16; empty_mean 0/1.  Each tile's keys are split into
// `parts` (1..4) CTAs, with a workspace (fp32, parts > 1) of tiles x parts x
// 64 x (dv + 2) floats, tiles = ceil(bs * H / KVH / 64) * (S / bs) * B *
// KVH.
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

// Resources of K8's body for dtype (0: the fp32 3xTF32 tile, 1: the bf16
// tile) and (dqk, dv) (launches nothing): out[5] = registers a thread,
// spill bytes a thread, shared memory bytes a CTA, CTAs resident on one SM,
// packed query rows a CTA.
int block_sparse_resources(int dtype, int dqk, int dv, int* out) {
  if (dqk == 64 && dv == 64) return (int)query<64, 64>(dtype, out);
  if (dqk == 128 && dv == 128) return (int)query<128, 128>(dtype, out);
  if (dqk == 192 && dv == 256) return (int)query<192, 256>(dtype, out);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
