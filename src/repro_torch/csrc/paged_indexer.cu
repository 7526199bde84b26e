// DSA lightning-indexer scores for Hopper (sm_90a): K5 decode and K6 span,
// both reading the paged k_idx pool IN PLACE through the block table.
//
// Replaces the TPU kernels of the JAX package:
//   K5  src/repro/kernels/paged_attention/kernel.py   paged_indexer_scores_kernel
//   K6  src/repro/kernels/paged_attention/prefill.py  paged_prefill_indexer
//
// Contract (the same as the Pallas kernels): token position p of row b lives
// at (tables[b, p / bs], p % bs) of k_pool (nb, bs, Di).  Packed query row r
// of batch row b is indexer head h = r % Hi of span token i = r / Hi (decode:
// S = 1 and starts = seq_lens).  For every view position p < mb*bs
//   out[b, i, p] = sum_h w[b, i*Hi + h] * (ReLU(q[b, i*Hi + h] . k[p]) * scale)
// (scale = Di^-1/2, passed in) when p's block starts at or before the span's
// last query position starts[b] + S - 1 -- the WHOLE block, past each query's
// own position too (the selector's causal mask drops those) -- and
// NEG_INF = -1e30 otherwise, without a read of the pool.  A row of length 0
// (an idle slot on the trash block) still gets finite scores in block 0.  q
// and the pool are in the model's dtype (float32 or bfloat16), w and the
// output float32; the products accumulate in fp32.
//
// What bounds it on this card.  No sum runs across keys: each key's score is
// independent, so unlike the attention kernels there is no online softmax
// and no combine pass.
//   K5 (decode, S = 1): bytes.  A live key costs Hi*(2*Di + 2) flops (2080 at
//     Yi-6B's 16 x 64) against its Di*2 = 128 bytes of bf16: ~16 flops a
//     byte, far below the card's ~295 flop/byte ridge.  The live keys are
//     read once and the whole (B, mb*bs) fp32 view is written.
//   K6 (span): at a full 256-token span, its S x live x Hi x (2*Di + 2) flops
//     (each key's bytes serve S*Hi query rows); at short spans the
//     (B, S, mb*bs) fp32 output it writes.
//
// What the design does:
//   * the Pallas grid is (B, mb), one block of keys a step; here the bf16
//     routes (the serving path: Yi-6B's 16 x 64, GLM-5's 32 x 128,
//     zamba2's 8 x 64) run the tensor-core bodies of indexer_mma.cuh with
//     the keys through the block table (PagedKeys below: a chunk's table
//     entries read once into shared memory): K6 the span body (shared
//     with K7) and K5 its decode form, each at 8, 16 or 32 heads; the
//     fp32 routes (the exact parity runs) and other head counts run the
//     SIMT tile of indexer_tile.cuh;
//   * K6 bf16: S^T = K Q^T on mma.sync m16n8k16, keys as the A operand
//     and a token's heads as N (indexer_mma.cuh's header); each key is
//     read from L2 once a token group and each query once a chunk (16 and
//     25 times at the Yi-6B serve span: ~20 MB of L2 reads against 3.3
//     GFLOP).  bf16 products are exact in fp32, so the scores are the
//     plain version's up to the order of the fp32 sums;
//   * K5 bf16: at the byte bound its 2080 flops a key would need ~54 of
//     the CUDA cores' 67 fp32 TFLOP/s, plus the bf16 -> fp32 conversions,
//     which the SIMT tile cannot reach; on the tensor cores the product is
//     nearly free.  The decode form gives every warp of a CTA the row's
//     one token and 32 keys of its own a round, the token's B fragments in
//     registers, so each live key is read once from device memory and the
//     grid of 128-position chunks fills the card at a decode step;
//   * every body: a position of a dead block gets NEG_INF and its key is
//     never read; a CTA whose positions are all dead writes and returns;
//     an idle slot (a row of length 0 on the trash block) reads the trash
//     block and stays finite;
//   * the SIMT tile: a CTA of 128 threads owns 128 consecutive view
//     positions (one a thread) and up to kMaxTok span tokens, stages its
//     tokens' queries and weights in shared memory as fp32 (read as
//     broadcasts), a thread holds its key's Di values in registers as fp32
//     and reuses them for every query row of the tile; a token's output row
//     is written by consecutive threads at consecutive positions.
// The routes by shape: K5 and K6 in bf16 with Hi 8, 16 or 32 (any Di the
// kernel takes) run the tensor-core bodies; every other call (fp32, or
// another head count) runs the SIMT tile.  Not done yet (later work):
// wgmma, TMA.
//
// Interface: plain C, loaded with ctypes.  Each entry point returns the
// cudaError_t of its launch (0 on success); it launches on the given stream,
// does not synchronise and allocates nothing.

#include <cuda_runtime.h>
#include <stddef.h>

#include <type_traits>

#include "indexer_mma.cuh"
#include "indexer_tile.cuh"

namespace {

// K5/K6's keys: position p of row b lives at (tables[b, p / bs], p % bs)
// of the pool; a block that starts after the span's last position
// (starts[b] + S - 1) is dead.
// The tensor-core bodies (indexer_mma.cuh) stage a chunk's table entries
// once a CTA.
struct PagedKeys {
  static constexpr bool kTable = true;
  const int* tables;
  const int* starts;
  int mb, bs, S;
  __host__ __device__ int len() const { return mb * bs; }
  __host__ __device__ int tokens() const { return S; }
  __device__ bool dead(int b, int p) const {
    return (p / bs) * bs > starts[b] + S - 1;
  }
  __device__ size_t slot(int b, int p) const {
    return (size_t)tables[(size_t)b * mb + p / bs] * bs + p % bs;
  }
  // the first position of row b's first dead block
  __device__ int live_end(int b) const {
    return ((starts[b] + S - 1) / bs + 1) * bs;
  }
  // the table entries of live positions p0 .. p1 - 1 into tab (the CTA's)
  __device__ void stage(int b, int p0, int p1, int* tab) const {
    for (int j = threadIdx.x; j <= (p1 - 1) / bs - p0 / bs; j += blockDim.x)
      tab[j] = tables[(size_t)b * mb + p0 / bs + j];
  }
  __device__ size_t row(int, int p, int p0, const int* tab) const {
    return (size_t)tab[p / bs - p0 / bs] * bs + p % bs;
  }
};


struct Args {
  const void* q;
  const float* w;
  const void* k_pool;
  const int* tables;
  const int* starts;
  float* out;
  int B, S, Hi, mb, bs;
  float scale;
};

template <typename T, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const PagedKeys keys{a.tables, a.starts, a.mb, a.bs, a.S};
  return launch_indexer_tiles<T, D>(a.q, a.w, a.k_pool, a.out, keys, a.B,
                                    a.S, a.Hi, a.scale, stream);
}

template <typename T>
cudaError_t launch_dim(int D, const Args& a, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(a, s);
    case 32: return launch<T, 32>(a, s);
    case 64: return launch<T, 64>(a, s);
    case 128: return launch<T, 128>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

int run(int dtype, int index_dim, const Args& a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.B <= 0 || a.S <= 0 || a.mb <= 0 || a.bs <= 0 || a.Hi <= 0
      || a.Hi * index_dim > kQFloats)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)launch_dim<float>(index_dim, a, s);
  if (dtype == 1) return (int)launch_dim<__nv_bfloat16>(index_dim, a, s);
  return (int)cudaErrorInvalidValue;
}

// out = {registers a thread, local (spill) bytes a thread, dynamic shared
// memory bytes a CTA, CTAs resident on one SM (as the runtime reports them),
// span tokens a CTA} for a span of kMaxTok tokens or more
template <typename T, int D>
cudaError_t query(int heads, int* out) {
  const int n_tok = tokens_per_cta(kMaxTok, heads, D);
  const size_t smem = smem_bytes(n_tok, heads, D);
  auto kern = indexer_tile_kernel<T, D, PagedKeys>;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kern);
  if (e != cudaSuccess) return e;
  int ctas = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kern, kThreads,
                                                    smem);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)smem;
  out[3] = ctas;
  out[4] = n_tok;
  return e;
}

template <typename T>
cudaError_t query_dim(int D, int heads, int* out) {
  switch (D) {
    case 16: return query<T, 16>(heads, out);
    case 32: return query<T, 32>(heads, out);
    case 64: return query<T, 64>(heads, out);
    case 128: return query<T, 128>(heads, out);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// K5.  q (B, Hi, Di); w (B, Hi) float32 (softmaxed head weights); k_pool
// (nb, bs, Di); tables (B, mb) int32; seq_lens (B,) int32 (the query's
// position); out (B, mb*bs) float32 in view coordinates.
// dtype of q and the pool: 0 = float32, 1 = bfloat16.
// bf16 at 8, 16 or 32 heads runs the tensor-core decode body, every other
// call the SIMT tile.
int paged_indexer_scores(int dtype, int index_dim, int block_size,
                         const void* q, const float* w, const void* k_pool,
                         const int* tables, const int* seq_lens, float* out,
                         int B, int heads, int mb, float scale, void* stream) {
  Args a{q, w, k_pool, tables, seq_lens, out, B, 1, heads, mb, block_size,
         scale};
  if (dtype != 1 || !indexer_mma::takes(heads, index_dim))
    return run(dtype, index_dim, a, stream);
  if (mb <= 0 || block_size <= 0) return (int)cudaErrorInvalidValue;
  const PagedKeys keys{tables, seq_lens, mb, block_size, 1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)indexer_mma::by_shape(heads, index_dim, [&](auto hi, auto di) {
    return indexer_mma::launch_decode<decltype(hi)::value,
                                      decltype(di)::value>(
        q, w, k_pool, out, keys, B, scale, s);
  });
}

// K6.  q (B, S*Hi, Di) packed rows i*Hi + h; w (B, S*Hi) float32; starts (B,)
// int32 (position of span token 0); out (B, S, mb*bs) float32.
// bf16 at 8, 16 or 32 heads runs the tensor-core span body, every other
// call the SIMT tile.
int paged_prefill_indexer(int dtype, int index_dim, int block_size,
                          const void* q, const float* w, const void* k_pool,
                          const int* tables, const int* starts, float* out,
                          int B, int SH, int heads, int mb, float scale,
                          void* stream) {
  if (heads <= 0 || SH % heads) return (int)cudaErrorInvalidValue;
  Args a{q, w, k_pool, tables, starts, out, B, SH / heads, heads, mb,
         block_size, scale};
  if (dtype != 1 || !indexer_mma::takes(heads, index_dim))
    return run(dtype, index_dim, a, stream);
  if (B <= 0 || a.S <= 0 || mb <= 0 || block_size <= 0)
    return (int)cudaErrorInvalidValue;
  const PagedKeys keys{tables, starts, mb, block_size, a.S};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)indexer_mma::by_shape(heads, index_dim, [&](auto hi, auto di) {
    return indexer_mma::launch<__nv_bfloat16, decltype(hi)::value,
                               decltype(di)::value>(q, w, k_pool, out, keys,
                                                    B, scale, s);
  });
}

// Resources of the SIMT tile (K5 and K6 in fp32 or at other head counts)
// for `dtype`, `index_dim` and `heads` (launches nothing): out[5] =
// registers a thread, spill bytes a thread, shared memory bytes a CTA, CTAs
// resident on one SM, span tokens a CTA.
int paged_indexer_resources(int dtype, int index_dim, int heads, int* out) {
  if (heads <= 0 || heads * index_dim > kQFloats)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)query_dim<float>(index_dim, heads, out);
  if (dtype == 1) return (int)query_dim<__nv_bfloat16>(index_dim, heads, out);
  return (int)cudaErrorInvalidValue;
}

// Resources of K5's bf16 tensor-core decode body (indexer_mma.cuh) for
// `heads` (8, 16 or 32) and `index_dim` (launches nothing;
// cudaErrorInvalidValue where K5 runs the SIMT tile): out[5] as above, the
// last the view positions a CTA.
int paged_indexer_scores_resources(int heads, int index_dim, int* out) {
  if (!indexer_mma::takes(heads, index_dim))
    return (int)cudaErrorInvalidValue;
  return (int)indexer_mma::by_shape(heads, index_dim, [&](auto hi, auto di) {
    return indexer_mma::resources_decode<decltype(hi)::value,
                                         decltype(di)::value, PagedKeys>(out);
  });
}

// Resources of K6's bf16 tensor-core body (indexer_mma.cuh) for `heads`
// (8, 16 or 32) and `index_dim` (launches nothing; cudaErrorInvalidValue
// where K6 runs the SIMT tile): out[5] as above, the last the span tokens a
// CTA.
int paged_prefill_indexer_resources(int heads, int index_dim, int* out) {
  if (!indexer_mma::takes(heads, index_dim))
    return (int)cudaErrorInvalidValue;
  return (int)indexer_mma::by_shape(heads, index_dim, [&](auto hi, auto di) {
    return indexer_mma::resources<__nv_bfloat16, decltype(hi)::value,
                                  decltype(di)::value, PagedKeys>(out);
  });
}

}  // extern "C"
