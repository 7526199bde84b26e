// Dense flash attention for Hopper (sm_90a): K9, the training path's
// attention over contiguous Q/K/V (no cache).
//
// Replaces the TPU kernel of the JAX package:
//   K9  src/repro/kernels/flash_attention/kernel.py  flash_attention
//
// Contract (the Pallas kernel's, with the GQA expansion of its ops.attend
// folded in): q and out (B, Sq, H, d), k and v (B, Sk, KVH, d), all in the
// model's layout; query head h reads KV head h / G (G = H / KVH) instead of
// K/V copied G times.  Query i sits at position q_offset + i, key j at j;
// a query attends every key j < Sk with j <= its position when causal, and
// with a window only position - j < window.  Scores are scaled by the given
// scale (d^-1/2), soft-capped c*tanh(s/c) before masking, masked entries
// count as NEG_INF = -1e30 in the running max and contribute p = 0, and the
// final division clamps the normaliser at 1e-20, as in the Pallas kernel
// (kernel.py:22,77): a query with no visible key gets 0.  Keys past the
// live range of a tile are never read; a short round stages zeros, so a
// masked p = 0 never meets stale shared memory (the Pallas kernel zeroes
// its padded key rows for the same reason: 0 x NaN).  fp32 accumulation;
// q/k/v/out in float32 or bfloat16.
//
// What bounds it on this card: arithmetic.  At the Yi-6B training shape
// (B 2, S 2048, H 32 / KVH 4, d 128, causal) the half of 4*B*H*S^2*d that
// the causal mask keeps is 69 GFLOP against 0.2 GB of q/k/v/out; with
// TF32 off, fp32 runs on the CUDA cores at 67 TFLOP/s (~1 ms a layer), or
// on the tensor cores as three TF32 products (3 x 69 GFLOP at 495
// TFLOP/s: 0.42 ms).
//
// Two bodies, chosen by dtype.  fp32 (the trainer's) runs tf32_tile.cuh's
// 3xTF32 tensor-core tile: each fp32 operand split into two TF32 values,
// three products summed in fp32, for fp32-level error (see that header).
// bf16 runs gqa_tile.cuh's SIMT body, shared with K1 and K2's fp32 route:
//   * the Pallas grid is (BH, n_q_blocks, n_k_blocks) with the key axis
//     sequential in VMEM scratch; here one CTA per (query-row tile, KV head,
//     batch row) loops over key tiles itself, starting at the first key of
//     its tile's window and stopping at the key of its last query (tiles
//     wholly above the causal diagonal or before the window are skipped;
//     the Pallas kernel visits and masks them, with the same result);
//   * a tile packs the G query heads of one KV head for consecutive
//     tokens (row r = token r / G, head r % G, as K2 packs a span), so each
//     staged K/V position serves every query row of the tile, and K/V are
//     read once per tile, not once per query head;
//   * 64 key positions of K and V a round are staged in shared memory as
//     fp32 (above 48 KB: the dynamic-shared-memory attribute, up to 174 KB
//     at d = 256); all of a round's loads are issued before any is used,
//     and where registers allow (bf16, d <= 128) the next round's are in
//     flight during this round's arithmetic;
//   * the accumulator (64 rows, 32 at d = 256) lives in registers, each
//     thread owning fixed columns; the online softmax is a warp per row.
// This file gives both bodies the contiguous layout (DenseKV below).  Not
// done yet (later work): the bf16 route on the tensor cores, wgmma and TMA,
// a split over keys for short sequences.
//
// Interface: plain C, loaded with ctypes.  The entry point returns the
// cudaError_t of its launch (0 on success); it launches on the given stream,
// does not synchronise and allocates nothing.

#include <cuda_runtime.h>
#include <stddef.h>

#include "gqa_tile.cuh"
#include "tf32_tile.cuh"

namespace {

// K9's layout: q and out (B, Sq, H, D), k and v (B, Sk, KVH, D); packed row
// r of (b, kv head) is head kvh * G + r % G of token r / G; a tile reads
// from the first key in its window to its last query's key, or every key
// when not causal.  It serves both bodies: gqa_tile.cuh's interface
// (start, q_row, kv_row, range) and, with grid y = batch row and z = KV
// head, tf32_tile.cuh's (rows, pos0, q_row, out_row, list_keys, key: flat
// key index = position).
struct DenseKV {
  static constexpr int kList = 1;        // no shared list
  static constexpr bool kMean = false;   // a row with no key gets 0
  int Sq, Sk, H, KVH, G, causal_, q_offset, window;
  __device__ int start(int) const { return q_offset; }
  __device__ bool causal() const { return causal_ != 0; }
  __device__ size_t q_row(int b, int kvh, int r) const {
    return ((size_t)b * Sq + r / G) * H + (size_t)kvh * G + r % G;
  }
  __device__ size_t kv_row(int b, int kvh, int pos) const {
    return ((size_t)b * Sk + pos) * KVH + kvh;
  }
  __device__ void range(int q_first, int q_last, int window_, int& lo,
                        int& hi) const {
    lo = window_ > 0 ? max(q_first - window_ + 1, 0) : 0;
    hi = causal_ ? min(q_last, Sk - 1) : Sk - 1;
  }
  __device__ int rows(int, int) const { return Sq * G; }
  __device__ int pos0(int, int) const { return q_offset; }
  __device__ size_t out_row(int b, int kvh, int r) const {
    return q_row(b, kvh, r);
  }
  __device__ void list_keys(int, int, int q_first, int q_last, int*,
                            int* lo_hi) const {
    range(q_first, q_last, window, lo_hi[0], lo_hi[1]);
  }
  __device__ int key(int b, int kvh, int t, const int*, size_t& row) const {
    row = kv_row(b, kvh, t);
    return t;
  }
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int B, Sq, Sk, H, KVH, causal, window, q_offset;
  float softcap, scale;
};

DenseKV dense_layout(const Args& a) {
  return DenseKV{a.Sq, a.Sk, a.H, a.KVH, a.H / a.KVH, a.causal, a.q_offset,
                 a.window};
}

// bf16: the SIMT body
template <int D, int ROWS>
cudaError_t launch_simt(const Args& a, cudaStream_t stream) {
  const int G = a.H / a.KVH;
  return launch_gqa_tiles<__nv_bfloat16, D, ROWS>(
      a.q, a.k, a.v, a.out, dense_layout(a), a.B, a.KVH, a.Sq * G, G,
      a.window, a.softcap, a.scale, stream);
}

// fp32: the 3xTF32 tensor-core tile
template <int D>
cudaError_t launch_tf32(const Args& a, cudaStream_t stream) {
  const int G = a.H / a.KVH;
  return tf32_tile::launch_attention<D, D>(a.q, a.k, a.v, a.out, nullptr,
                                           dense_layout(a), a.Sq * G, a.B,
                                           a.KVH, 1, a.softcap, a.scale,
                                           stream);
}

// SIMT tiles: 64 rows at d <= 128, 32 at d = 256 (register budget of the
// per-thread accumulator, shared memory of the staged tiles)
cudaError_t dispatch(int dtype, int d, const Args& a, cudaStream_t s) {
  if (dtype == 0) {
    switch (d) {
      case 64: return launch_tf32<64>(a, s);
      case 128: return launch_tf32<128>(a, s);
      case 256: return launch_tf32<256>(a, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == 1) {
    switch (d) {
      case 64: return launch_simt<64, 64>(a, s);
      case 128: return launch_simt<128, 64>(a, s);
      case 256: return launch_simt<256, 32>(a, s);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K9.  q/out (B, Sq, H, d); k/v (B, Sk, KVH, d), H a multiple of KVH;
// dtype: 0 = float32, 1 = bfloat16; causal 0/1; window 0 = none.
int flash_attention(int dtype, int head_dim, const void* q, const void* k,
                    const void* v, void* out, int B, int Sq, int Sk, int H,
                    int KVH, int causal, int window, int q_offset,
                    float softcap, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KVH <= 0 || H % KVH)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, out, B, Sq, Sk, H, KVH, causal, window, q_offset, softcap,
         scale};
  return (int)dispatch(dtype, head_dim, a, static_cast<cudaStream_t>(stream));
}

// Resources of K9's fp32 (3xTF32 tensor-core) tile for `head_dim`
// (launches nothing): out[5] = registers a thread, spill bytes a thread,
// shared memory bytes a CTA, CTAs resident on one SM, packed query rows a
// CTA.
int flash_attention_resources(int head_dim, int* out) {
  switch (head_dim) {
    case 64: return (int)tf32_tile::resources<64, 64, DenseKV>(out);
    case 128: return (int)tf32_tile::resources<128, 128, DenseKV>(out);
    case 256: return (int)tf32_tile::resources<256, 256, DenseKV>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
