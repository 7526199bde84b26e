// Paged GQA attention for Hopper (sm_90a): K1 flash-decode and K2 span
// prefill, both reading K/V blocks IN PLACE through the block table.
//
// Replaces the TPU kernels of the JAX package:
//   K1  src/repro/kernels/paged_attention/kernel.py   paged_decode_gqa
//   K2  src/repro/kernels/paged_attention/prefill.py  paged_prefill_gqa
//
// Contract (the same as the Pallas kernels): token position p of row b lives
// at (tables[b, p / BS], p % BS); packed query row r of (b, kv-head) is group
// query g = r % G of span token i = r / G at absolute position starts[b] + i
// (decode: S = 1 and starts = seq_lens).  A query attends every position
// k_pos <= q_pos, and with a window only q_pos - k_pos < window.  Scores are
// scaled by d^-1/2, soft-capped c*tanh(s/c) before masking, and folded with
// an fp32 online softmax; the final division clamps l at 1e-20 so a trash
// row (length 0) still gives a finite output.
//
// What bounds it on this card: the live K/V bytes.  Decode reads
// (seq_len + 1) * KVH * d * 2 values per row and does 4 flops per value and
// group query, far below the ~295 flop/byte ridge of an H100 in bf16; span
// prefill at S*G rows per kv-head does S*G times more work per byte and,
// at the chunk sizes the engine uses, is bound by its arithmetic.
//
// What the design does about it:
//   * one CTA per (query-row tile, kv-head, batch row) walks only that
//     tile's live blocks itself: it loads its own table entries and start,
//     begins at the first in-window block and stops at the block of its
//     last query position (causal early exit per tile), so traffic is
//     O(live tokens) and nothing is gathered into a padded view;
//   * kTokens positions of K and V are staged in shared memory as fp32 and
//     scored against every query row of the tile, so each K/V byte is read
//     from device memory once per tile; all of a round's loads are issued
//     before any is used and, where registers allow (bf16, d <= 128), the
//     next round's loads are in flight while this round computes;
//   * the Pallas prefill kernel keeps the whole packed span resident (4 MB
//     of fp32 accumulator at S = 1024, G = 8, d = 128); here the query rows
//     are tiled (64 rows per CTA, 32 at d = 256) and the accumulator lives in
//     registers, each thread owning fixed columns of the tile.
// The tile body is gqa_tile.cuh's, shared with K9; this file gives it the
// paged layout (PagedKV below).
// Not done yet (later work): split-KV with a combine pass (decode at B = 8
// fills only B * KVH CTAs of 132 SMs), tensor cores (wgmma), TMA.
//
// Interface: plain C, loaded with ctypes.  Each entry point returns the
// cudaError_t of its launch (0 on success); it launches on the given stream,
// does not synchronise and allocates nothing.

#include <cuda_runtime.h>
#include <stddef.h>

#include "gqa_tile.cuh"

namespace {

constexpr int kRowsDecode = 8;     // query rows per CTA for K1 (G <= 8: one tile)

// K1/K2's layout: packed query rows (b, kv head, r) are contiguous; token
// position p of row b lives at (tables[b, p / BS], p % BS) of the pools;
// every span is causal by absolute position, and a tile reads from the
// first block in its window to the block of its last query.
template <int BS>
struct PagedKV {
  const int* tables;
  const int* starts;
  int KVH, SG, mb;
  __device__ int start(int b) const { return starts[b]; }
  __device__ bool causal() const { return true; }
  __device__ size_t q_row(int b, int kvh, int r) const {
    return ((size_t)b * KVH + kvh) * SG + r;
  }
  __device__ size_t kv_row(int b, int kvh, int pos) const {
    return ((size_t)tables[(size_t)b * mb + pos / BS] * BS + pos % BS) * KVH
           + kvh;
  }
  __device__ void range(int q_first, int q_last, int window, int& lo,
                        int& hi) const {
    lo = window > 0 ? max(q_first - window + 1, 0) : 0;
    lo = (lo / BS) * BS;
    hi = min(q_last, mb * BS - 1);
  }
};

struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const int* tables;
  const int* starts;
  void* out;
  int B, KVH, SG, G, mb, window;
  float softcap, scale;
};

template <typename T, int D, int BS, int ROWS>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const PagedKV<BS> layout{a.tables, a.starts, a.KVH, a.SG, a.mb};
  return launch_gqa_tiles<T, D, ROWS>(a.q, a.k_pool, a.v_pool, a.out, layout,
                                      a.B, a.KVH, a.SG, a.G, a.window,
                                      a.softcap, a.scale, stream);
}

template <typename T, int D, int ROWS>
cudaError_t by_block(int bs, const Args& a, cudaStream_t s) {
  switch (bs) {
    case 8: return launch<T, D, 8, ROWS>(a, s);
    case 16: return launch<T, D, 16, ROWS>(a, s);
    case 32: return launch<T, D, 32, ROWS>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

// prefill tiles: 64 rows at d <= 128, 32 at d = 256 (register budget of
// the per-thread accumulator, shared memory of the staged tiles)
template <typename T>
cudaError_t dispatch(bool decode, int d, int bs, const Args& a,
                     cudaStream_t s) {
  switch (d) {
    case 64:
      return decode ? by_block<T, 64, kRowsDecode>(bs, a, s)
                    : by_block<T, 64, 64>(bs, a, s);
    case 128:
      return decode ? by_block<T, 128, kRowsDecode>(bs, a, s)
                    : by_block<T, 128, 64>(bs, a, s);
    case 256:
      return decode ? by_block<T, 256, kRowsDecode>(bs, a, s)
                    : by_block<T, 256, 32>(bs, a, s);
    default: return cudaErrorInvalidValue;
  }
}

int run(bool decode, int dtype, int d, int bs, const Args& a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(decode, d, bs, a, s);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(decode, d, bs, a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K1.  q (B, KVH, G, d); pools (nb, bs, KVH, d); tables (B, mb) int32;
// seq_lens (B,) int32 (the query's position); out (B, KVH, G, d).
// dtype: 0 = float32, 1 = bfloat16.
int paged_decode_gqa(int dtype, int head_dim, int block_size, const void* q,
                     const void* k_pool, const void* v_pool,
                     const int* tables, const int* seq_lens, void* out, int B,
                     int KVH, int G, int mb, int window, float softcap,
                     float scale, void* stream) {
  Args a{q, k_pool, v_pool, tables, seq_lens, out, B, KVH, G, G, mb,
         window, softcap, scale};
  return run(true, dtype, head_dim, block_size, a, stream);
}

// K2.  q (B, KVH, S*G, d) packed rows i*G + g; starts (B,) int32 (position
// of span token 0); out like q.
int paged_prefill_gqa(int dtype, int head_dim, int block_size, const void* q,
                      const void* k_pool, const void* v_pool,
                      const int* tables, const int* starts, void* out, int B,
                      int KVH, int SG, int G, int mb, int window,
                      float softcap, float scale, void* stream) {
  Args a{q, k_pool, v_pool, tables, starts, out, B, KVH, SG, G, mb,
         window, softcap, scale};
  return run(false, dtype, head_dim, block_size, a, stream);
}

}  // extern "C"
