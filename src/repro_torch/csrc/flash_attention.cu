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
// Two bodies, chosen by dtype, both on the tensor cores and both walking
// the keys through DenseKV below (grid y = batch row, z = KV head):
//   * fp32 (the trainer's) runs tf32_tile.cuh's 3xTF32 tile: each fp32
//     operand split into two TF32 values, three products summed in fp32,
//     for fp32-level error (see that header);
//   * bf16 (the RL loop backend's re-forward: B 1, S 240, 32 / 4 heads x
//     128) runs mma_tile.cuh's bf16 tile, the one K2 and K8 share:
//     mma.sync m16n8k16 with fp32 accumulators, K/V bf16 in a cp.async
//     ring of 64-key rounds, P rounded to bf16 for PV (as the model path's
//     dense_attention does; the Pallas kernel keeps P in fp32, so this
//     route is held at the bf16 bound), scores scaled in fp32 and then
//     soft-capped.  At d 256 the output columns split over two groups of
//     4 warps.
// Head dims 64, 80 (zamba2's shared block: 32 heads of 80, its training
// forward), 96 (phi-3-vision: 32 heads of 96), 128 and 256.  At d 80 and
// 96 both tiles take the width as it is: the 3xTF32 tile ten / twelve
// n-tiles of 8 output columns a warp (rows of 88 / 84 and 104 / 100 floats
// in shared memory), the bf16 tile five / six k-steps of 16, as K2's body
// does at those widths.
// Both tiles pack the G query heads of one KV head for consecutive tokens
// into 64-row tiles (row r = token r / G, head r % G), so each staged K/V
// position serves every query row of the tile and K/V are read once per
// tile, not once per query head; a tile reads from the first key of its
// window to the key of its last query (every key when not causal).  Each
// tile's key rounds split over `parts` CTAs (<= 4) where the tiles leave
// SMs empty (bf16; fp32 takes 1): the wrapper picks parts and allocates the
// fp32 workspace that mma_tile.cuh's combine kernel folds.  The loop shape
// has 30 row tiles x 4 KV heads = 120 tiles for 132 SMs, so parts 1: a
// second CTA an SM (parts 2, as K2's slot rule would pick) measured slower
// with the combine pass than without.
//
// What holds the bf16 route at the loop shape (H100, measured with
// tile_study.py's flash_bf16 study): ~8 us a call that does not depend on
// the keys (launch, the prologue, the first round's latency) and ~1.8 us a
// 64-key round of the longest (diagonal) tile: the tile's mma.sync rate,
// ~1.2 TFLOP/s an SM (K2's and K8's 0.85-1.2).  The tile built with 3 or
// 4 K/V buffers instead of 2 moved it by under 3 % (a round is not waiting
// on its copies), and at 4 the 155 KB a CTA leaves one CTA an SM, 1.4x
// slower at B 4: the tile keeps 2.
// Not done yet (later work): wgmma and TMA.
//
// Interface: plain C, loaded with ctypes.  The entry point returns the
// cudaError_t of its launch (0 on success); it launches on the given stream,
// does not synchronise and allocates nothing.

#include <cuda_runtime.h>
#include <stddef.h>

#include <type_traits>

#include "mma_tile.cuh"
#include "tf32_tile.cuh"

namespace {

// K9's layout: q and out (B, Sq, H, D), k and v (B, Sk, KVH, D); packed row
// r of (b, kv head) is head kvh * G + r % G of token r / G; a tile reads
// from the first key in its window to its last query's key, or every key
// when not causal.  The interface of mma_tile.cuh's tile and tf32_tile.cuh's
// (grid y = batch row, z = KV head: rows, pos0, q_row, out_row, list_keys,
// key: flat key index = position, causal).
struct DenseKV {
  static constexpr int kList = 1;        // no shared list
  static constexpr bool kMean = false;   // a row with no key gets 0
  int Sq, Sk, H, KVH, G, causal_, q_offset, window;
  __device__ bool causal() const { return causal_ != 0; }
  __device__ size_t q_row(int b, int kvh, int r) const {
    return ((size_t)b * Sq + r / G) * H + (size_t)kvh * G + r % G;
  }
  __device__ int rows(int, int) const { return Sq * G; }
  __device__ int pos0(int, int) const { return q_offset; }
  __device__ size_t out_row(int b, int kvh, int r) const {
    return q_row(b, kvh, r);
  }
  __device__ void list_keys(int, int, int q_first, int q_last, int*,
                            int* lo_hi) const {
    lo_hi[0] = window > 0 ? max(q_first - window + 1, 0) : 0;
    lo_hi[1] = causal_ ? min(q_last, Sk - 1) : Sk - 1;
  }
  __device__ int key(int b, int kvh, int t, const int*, size_t& row) const {
    row = ((size_t)b * Sk + t) * KVH + kvh;
    return t;
  }
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  void* ws;
  int B, Sq, Sk, H, KVH, causal, window, q_offset, parts;
  float softcap, scale;
};

DenseKV dense_layout(const Args& a) {
  return DenseKV{a.Sq, a.Sk, a.H, a.KVH, a.H / a.KVH, a.causal, a.q_offset,
                 a.window};
}

// fp32: the 3xTF32 tensor-core tile (a one-dimensional grid)
template <int D>
cudaError_t launch_tf32(const Args& a, cudaStream_t stream) {
  return tf32_tile::launch_attention<D, D>(
      a.q, a.k, a.v, a.out, a.ws, dense_layout(a), a.Sq * (a.H / a.KVH),
      a.B, a.KVH, a.parts, a.softcap, a.scale, stream);
}

// bf16: the bf16 tensor-core tile (grid y = batch row, z = KV head)
template <int D>
cudaError_t launch_bf16(const Args& a, cudaStream_t stream) {
  if (a.B > 65535 || a.KVH > 65535) return cudaErrorInvalidValue;
  return mma_tile::launch_attention<D, D, DenseKV>(
      a.q, a.k, a.v, a.out, a.ws, dense_layout(a), a.Sq * (a.H / a.KVH),
      a.B, a.KVH, a.parts, a.softcap, a.scale, stream);
}

// head_dim -> f(D) over the instantiated head dims
template <typename F>
cudaError_t by_dim(int d, F f) {
  switch (d) {
    case 64: return f(std::integral_constant<int, 64>());
    case 80: return f(std::integral_constant<int, 80>());
    case 96: return f(std::integral_constant<int, 96>());
    case 128: return f(std::integral_constant<int, 128>());
    case 256: return f(std::integral_constant<int, 256>());
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(int dtype, int d, const Args& a, cudaStream_t s) {
  return by_dim(d, [&](auto D) {
    constexpr int kD = decltype(D)::value;
    if (dtype == 0) return launch_tf32<kD>(a, s);
    if (dtype == 1) return launch_bf16<kD>(a, s);
    return cudaErrorInvalidValue;
  });
}

}  // namespace

extern "C" {

// K9.  q/out (B, Sq, H, d); k/v (B, Sk, KVH, d), H a multiple of KVH;
// dtype: 0 = float32, 1 = bfloat16; causal 0/1; window 0 = none; each
// 64-row tile's keys split over `parts` CTAs (1..4), with an fp32
// workspace of tiles x parts x 64 x (d + 2) floats where parts > 1.
int flash_attention(int dtype, int head_dim, const void* q, const void* k,
                    const void* v, void* out, int B, int Sq, int Sk, int H,
                    int KVH, int causal, int window, int q_offset,
                    float softcap, float scale, int parts, void* workspace,
                    void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KVH <= 0 || H % KVH)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, out, workspace, B, Sq, Sk, H, KVH, causal, window,
         q_offset, parts, softcap, scale};
  return (int)dispatch(dtype, head_dim, a, static_cast<cudaStream_t>(stream));
}

// Resources of K9's tile for `dtype` (0: the fp32 3xTF32 tile, 1: the bf16
// tile) and `head_dim` (launches nothing): out[5] = registers a thread,
// spill bytes a thread, shared memory bytes a CTA, CTAs resident on one SM,
// packed query rows a CTA.
int flash_attention_resources(int dtype, int head_dim, int* out) {
  return (int)by_dim(head_dim, [&](auto D) {
    constexpr int kD = decltype(D)::value;
    if (dtype == 0) return tf32_tile::resources<kD, kD, DenseKV>(out);
    if (dtype == 1)
      return mma_tile::resources<kD, kD, DenseKV>(out);
    return cudaErrorInvalidValue;
  });
}

}  // extern "C"
