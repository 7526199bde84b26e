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
// an fp32 online softmax; a row that sees no key gets 0 (the final division
// clamps l at 1e-20).
//
// What bounds it on this card: decode reads (seq_len + 1) * KVH * d * 2
// values per row and does 4 flops per value and group query, far below the
// ~295 flop/byte ridge of an H100 in bf16: the live K/V bytes bound it.
// Span prefill at S*G rows per kv-head does S*G times more work per byte
// and, at the chunk sizes the engine uses, is bound by its arithmetic.
//
// What the design does about it:
//   * one CTA per (query-row tile, kv-head, batch row) walks only that
//     tile's live blocks itself: it loads its own table entries and start,
//     begins at the first in-window block and stops at the block of its
//     last query position (causal early exit per tile), so traffic is
//     O(live tokens) and nothing is gathered into a padded view;
//   * the Pallas prefill kernel keeps the whole packed span resident (4 MB
//     of fp32 accumulator at S = 1024, G = 8, d = 128); here the query rows
//     are tiled and the accumulator lives in registers;
//   * the body is chosen by dtype.  bf16 span prefill, the serving path,
//     runs mma_tile.cuh's tensor-core tile (mma.sync QK^T and PV, K/V kept
//     bf16 in a cp.async ring, the tile's causal key range split over up
//     to 4 CTAs and folded by a combine pass so the 128 tiles of a serve
//     span fill the card): PagedSpan below is its layout.  fp32 span
//     prefill (the exact parity runs) and decode in both dtypes run
//     gqa_tile.cuh's SIMT body (K/V staged as fp32, scalar FMAs), shared
//     with K9: PagedKV below is its layout.  Decode at 4 flops a byte gains
//     nothing from tensor cores.
// Not done yet (later work): split-KV for decode (B = 8 fills only B * KVH
// CTAs of 132 SMs), wgmma and TMA for the span tile.
//
// Interface: plain C, loaded with ctypes.  Each entry point returns the
// cudaError_t of its launch (0 on success); it launches on the given stream,
// does not synchronise and allocates nothing.

#include <cuda_runtime.h>
#include <stddef.h>

#include "gqa_tile.cuh"
#include "mma_tile.cuh"

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

// K2's layout on the tensor-core tile (grid y = kv head, z = batch row):
// the same rows and keys as PagedKV, flat key index = position.
template <int BS>
struct PagedSpan {
  static constexpr int kList = 1;        // no shared list
  static constexpr bool kMean = false;   // a row with no key gets 0
  const int* tables;
  const int* starts;
  int KVH, SG, G, mb, window;
  __device__ int rows(int, int) const { return SG; }
  __device__ int pos0(int, int z) const { return starts[z]; }
  __device__ size_t q_row(int y, int z, int r) const {
    return ((size_t)z * KVH + y) * SG + r;
  }
  __device__ size_t out_row(int y, int z, int r) const {
    return q_row(y, z, r);
  }
  __device__ void list_keys(int, int, int q_first, int q_last, int*,
                            int* range) const {
    const int lo = window > 0 ? max(q_first - window + 1, 0) : 0;
    range[0] = (lo / BS) * BS;
    range[1] = min(q_last, mb * BS - 1);
  }
  __device__ int key(int y, int z, int t, const int*, size_t& row) const {
    row = ((size_t)__ldg(tables + (size_t)z * mb + t / BS) * BS + t % BS)
          * KVH + y;
    return t;
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
  int parts;
  void* ws;
};

// the SIMT body: decode (kRowsDecode rows a CTA) in both dtypes, fp32 span
// prefill (64 rows a CTA at d <= 128, 32 at d = 256: the register budget of
// the per-thread accumulator, the shared memory of the fp32 tiles)
template <typename T, int D, int BS, int ROWS>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const PagedKV<BS> layout{a.tables, a.starts, a.KVH, a.SG, a.mb};
  return launch_gqa_tiles<T, D, ROWS>(a.q, a.k_pool, a.v_pool, a.out, layout,
                                      a.B, a.KVH, a.SG, a.G, a.window,
                                      a.softcap, a.scale, stream);
}

// the tensor-core body: bf16 span prefill
template <int D, int BS>
cudaError_t launch_mma(const Args& a, cudaStream_t stream) {
  const PagedSpan<BS> layout{a.tables, a.starts, a.KVH, a.SG, a.G, a.mb,
                             a.window};
  return mma_tile::launch_attention<D, D>(a.q, a.k_pool, a.v_pool, a.out,
                                          a.ws, layout, a.SG, a.KVH, a.B,
                                          a.parts, a.softcap, a.scale,
                                          stream);
}

template <int D, int BS>
cudaError_t launch_block(int dtype, bool decode, const Args& a,
                         cudaStream_t s) {
  constexpr int kRowsPrefill = D <= 128 ? 64 : 32;
  if (decode && dtype == 0) return launch<float, D, BS, kRowsDecode>(a, s);
  if (decode && dtype == 1)
    return launch<__nv_bfloat16, D, BS, kRowsDecode>(a, s);
  if (dtype == 0) return launch<float, D, BS, kRowsPrefill>(a, s);
  if (dtype == 1) return launch_mma<D, BS>(a, s);
  return cudaErrorInvalidValue;
}

template <int D>
cudaError_t by_block(int dtype, bool decode, int bs, const Args& a,
                     cudaStream_t s) {
  switch (bs) {
    case 8: return launch_block<D, 8>(dtype, decode, a, s);
    case 16: return launch_block<D, 16>(dtype, decode, a, s);
    case 32: return launch_block<D, 32>(dtype, decode, a, s);
    default: return cudaErrorInvalidValue;
  }
}

int run(bool decode, int dtype, int d, int bs, const Args& a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return (int)by_block<64>(dtype, decode, bs, a, s);
    case 128: return (int)by_block<128>(dtype, decode, bs, a, s);
    case 256: return (int)by_block<256>(dtype, decode, bs, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int D>
cudaError_t query(int bs, int* out) {
  switch (bs) {
    case 8: return mma_tile::resources<D, D, PagedSpan<8>>(out);
    case 16: return mma_tile::resources<D, D, PagedSpan<16>>(out);
    case 32: return mma_tile::resources<D, D, PagedSpan<32>>(out);
    default: return cudaErrorInvalidValue;
  }
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
         window, softcap, scale, 1, nullptr};
  return run(true, dtype, head_dim, block_size, a, stream);
}

// K2.  q (B, KVH, S*G, d) packed rows i*G + g; starts (B,) int32 (position
// of span token 0); out like q.  bf16 only: each row tile's keys split into
// `parts` (1..4) CTAs, workspace (fp32, parts > 1) of tiles x parts x 64 x
// (d + 2) floats, tiles = ceil(S*G / 64) * KVH * B; fp32 takes parts = 1.
int paged_prefill_gqa(int dtype, int head_dim, int block_size, const void* q,
                      const void* k_pool, const void* v_pool,
                      const int* tables, const int* starts, void* out, int B,
                      int KVH, int SG, int G, int mb, int window,
                      float softcap, float scale, int parts, void* workspace,
                      void* stream) {
  if (dtype == 0 && parts != 1) return (int)cudaErrorInvalidValue;
  Args a{q, k_pool, v_pool, tables, starts, out, B, KVH, SG, G, mb,
         window, softcap, scale, parts, workspace};
  return run(false, dtype, head_dim, block_size, a, stream);
}

// Resources of K2's bf16 (tensor-core) span body for (head_dim,
// block_size) (launches nothing): out[5] = registers a thread, spill bytes a
// thread, shared memory bytes a CTA, CTAs resident on one SM, packed query
// rows a CTA.
int paged_prefill_gqa_resources(int head_dim, int block_size, int* out) {
  switch (head_dim) {
    case 64: return (int)query<64>(block_size, out);
    case 128: return (int)query<128>(block_size, out);
    case 256: return (int)query<256>(block_size, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
