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
//   * the Pallas grid is (B, mb), one block of keys a step; here K6's bf16
//     route (the serving path) runs a tensor-core body of its own
//     (span_mma below) and K5 and K6's fp32 route (the exact parity runs)
//     the SIMT tile of indexer_tile.cuh, shared with K7;
//   * K6 bf16, span_mma: the span's scores are an (S*Hi) x Di by Di x keys
//     product with a ReLU and a weighted head sum after it.  It runs on
//     mma.sync m16n8k16 (bf16 in, fp32 accumulate) as S^T = K Q^T, the
//     heads as the product's N: K (16 keys x 16 dims) is the A operand,
//     by ldmatrix from shared memory; Q^T (16 dims x 8 heads) the B
//     operand, a token's Hi heads 2 n-tiles at Hi 16 and 4 at Hi 32, held
//     in registers for the kTokens tokens a warp owns (4 at 16 x 64, 1 at
//     32 x 128: at most 64 registers of queries).  A CTA of 4 warps owns a
//     chunk of kChunk view positions and 4 x kTokens span tokens; its
//     chunk's keys come through the block table (its entries read once
//     into shared memory) in rounds of 64 positions, by cp.async 16-byte
//     copies into a 2-buffer ring, each round's copies in flight while the
//     last computes.  Each key is read from L2 once a token group and each
//     query once a chunk (16 and 25 times at the Yi-6B serve span: ~20 MB
//     of L2 reads against 3.3 GFLOP).  The epilogue works on the
//     accumulator: each thread applies ReLU, scale and its heads' weights
//     to its columns and sums them, two __shfl_xor (1, 2) over the quad
//     finish the head sum for keys g and g + 8, and the sums go through
//     shared memory so that a token's 64 scores of a round go out in two
//     128-byte rows.  bf16 products are exact in fp32, so the scores are
//     the plain version's up to the order of the fp32 sums;
//   * both bodies: a position of a dead block gets NEG_INF and its key is
//     never read; a CTA whose positions are all dead writes and returns;
//     an idle slot (a row of length 0 on the trash block) reads the trash
//     block and stays finite;
//   * the SIMT tile: a CTA of 128 threads owns 128 consecutive view
//     positions (one a thread) and up to kMaxTok span tokens, stages its
//     tokens' queries and weights in shared memory as fp32 (read as
//     broadcasts), a thread holds its key's Di values in registers as fp32
//     and reuses them for every query row of the tile; a token's output row
//     is written by consecutive threads at consecutive positions.
// The routes by shape: K6 in bf16 with Hi 16 or 32 (Yi-6B's 16 x 64,
// GLM-5's 32 x 128; any Di the kernel takes) runs span_mma; every other
// K6 call (fp32, or another head count) and every K5 call runs the SIMT
// tile.  The key chunk and the tokens a warp are compile-time knobs
// (REPRO_IDX_ROUNDS, REPRO_IDX_TOKENS) so tile_study.py can build and time
// others.  Not done yet (later work): K5 and K7 on the tensor cores, wgmma,
// TMA.
//
// Interface: plain C, loaded with ctypes.  Each entry point returns the
// cudaError_t of its launch (0 on success); it launches on the given stream,
// does not synchronise and allocates nothing.

#include <cuda_runtime.h>
#include <stddef.h>

#include <type_traits>

#include "indexer_tile.cuh"
#include "mma_tile.cuh"

namespace {

// K5/K6's keys: position p of row b lives at (tables[b, p / bs], p % bs)
// of the pool; a block that starts after the span's last position
// (starts[b] + S - 1) is dead.
struct PagedKeys {
  const int* tables;
  const int* starts;
  int mb, bs, S;
  __host__ __device__ int len() const { return mb * bs; }
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
};

// K6's bf16 span body on the tensor cores (see the header)
namespace span_mma {

using bf16 = __nv_bfloat16;
using mma_tile::cp_async16;
using mma_tile::cp_async_commit;
using mma_tile::cp_async_wait;
using mma_tile::ldsm_x4;
using mma_tile::mma16816;

#ifndef REPRO_IDX_ROUNDS
#define REPRO_IDX_ROUNDS 4
#endif
#ifndef REPRO_IDX_TOKENS
#define REPRO_IDX_TOKENS 4
#endif

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kKeys = 64;                        // positions a round
constexpr int kStages = 2;                       // key buffers
constexpr int kChunk = kKeys * REPRO_IDX_ROUNDS;  // positions a CTA
constexpr int kPad = 8;                          // bf16 padding a row

template <int HI, int DI>
struct Shape {
  static constexpr int kNT = HI / 8;     // n-tiles of 8 heads
  static constexpr int kKS = DI / 16;    // k-steps of 16 dims
  // tokens a warp: at most 4096 query values (64 registers of bf16 pairs)
  static constexpr int kTokens = 4096 / (HI * DI) < 1 ? 1
      : (4096 / (HI * DI) > REPRO_IDX_TOKENS ? REPRO_IDX_TOKENS
                                             : 4096 / (HI * DI));
  static constexpr int kTok = kWarps * kTokens;   // tokens a CTA
  static constexpr int kLd = DI + kPad;   // bf16 row of a query head or key
  static constexpr int kLdO = kKeys + 4;  // fp32 row of staged scores
  static constexpr size_t kSmem =
      ((size_t)kTok * HI * kLd + (size_t)kStages * kKeys * kLd) * 2
      + (size_t)kTok * kLdO * 4 + (size_t)(kChunk + 1) * 4;
  static_assert(HI % 16 == 0 && DI % 16 == 0, "span_mma shape");
};

// whether K6 at (heads, index_dim) runs this body in bf16
inline bool takes(int heads, int index_dim) {
  return (heads == 16 || heads == 32) && index_dim % 16 == 0 &&
         index_dim <= 128;
}

template <int HI, int DI>
__global__ void __launch_bounds__(kThreads)
span_kernel(const bf16* __restrict__ q, const float* __restrict__ w,
            const bf16* __restrict__ k, float* __restrict__ out,
            PagedKeys keys, float scale) {
  using Sh = Shape<HI, DI>;
  constexpr int NT = Sh::kNT, KS = Sh::kKS, TW = Sh::kTokens;
  constexpr int TOK = Sh::kTok, LD = Sh::kLd, LDO = Sh::kLdO;
  constexpr int CH = DI / 8;   // 16-byte chunks a row

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);           // [TOK * HI][LD]
  bf16* Ks = Qs + TOK * HI * LD;                      // [kStages][kKeys][LD]
  float* Os = reinterpret_cast<float*>(Ks + kStages * kKeys * LD);
  int* Tab = reinterpret_cast<int*>(Os + TOK * LDO);  // the chunk's blocks

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int S = keys.S, bs = keys.bs, len = keys.len();
  const int c0 = blockIdx.x * kChunk;   // the chunk's first position
  const int i0 = blockIdx.y * TOK;      // its first token
  const int b = blockIdx.z;
  const int toks = min(TOK, S - i0);
  const int c_end = min(c0 + kChunk, len);
  const int live = min(c_end, keys.live_end(b));   // dead from here on
  float* o = out + ((size_t)b * S + i0) * len;

  // the chunk's dead positions: NEG_INF, nothing read
  const int d0 = max(c0, live), n_dead = c_end - d0;
  for (int e = tid; e < toks * n_dead; e += kThreads)
    o[(size_t)(e / n_dead) * len + d0 + e % n_dead] = kNegInf;
  if (live <= c0) return;

  // the block table's entries of the chunk's live blocks
  const int blk0 = c0 / bs;
  for (int j = tid; j <= (live - 1) / bs - blk0; j += kThreads)
    Tab[j] = keys.tables[(size_t)b * keys.mb + blk0 + j];
  // the CTA's queries; tokens past the span are zero-filled, never written
  const bf16* qsrc = q + ((size_t)b * S + i0) * HI * DI;
  for (int i = tid; i < TOK * HI * CH; i += kThreads) {
    const int r = i / CH, e = (i % CH) * 8;
    const bool ok = r / HI < toks;
    cp_async16(Qs + r * LD + e, qsrc + (ok ? (size_t)r * DI + e : 0), ok);
  }
  __syncthreads();   // Tab

  const int rounds = (live - c0 + kKeys - 1) / kKeys;
  // round rd's keys into stage rd % kStages; a position past the live
  // ones is zero-filled
  auto issue = [&](int rd) {
    if (rd >= rounds) return;
    const int p0 = c0 + rd * kKeys;
    bf16* dst = Ks + (rd % kStages) * kKeys * LD;
    for (int i = tid; i < kKeys * CH; i += kThreads) {
      const int j = i / CH, e = (i % CH) * 8, p = p0 + j;
      const bool ok = p < live;
      const size_t row =
          ok ? (size_t)Tab[p / bs - blk0] * bs + p % bs : 0;
      cp_async16(dst + j * LD + e, k + row * DI + e, ok);
    }
  };
  issue(0);
  cp_async_commit();   // the queries and the first round

  // this thread's head weights: heads n*8 + 2*t4 and + 1 of each token
  float wv[TW][NT][2];
#pragma unroll
  for (int t = 0; t < TW; ++t) {
    const int tok = warp * TW + t;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int u = 0; u < 2; ++u)
        wv[t][n][u] = tok < toks
            ? w[((size_t)b * S + i0 + tok) * HI + n * 8 + 2 * t4 + u] : 0.f;
  }
  uint32_t qf[TW][NT][KS][2];   // B fragments of the warp's tokens

  for (int rd = 0; rd < rounds; ++rd) {
    cp_async_wait<0>();
    // round rd has landed, and every reader of the stage refilled below
    // (round rd - 1's) is done
    __syncthreads();
    issue(rd + 1);
    cp_async_commit();
    if (rd == 0) {
#pragma unroll
      for (int t = 0; t < TW; ++t)
#pragma unroll
        for (int n2 = 0; n2 < NT / 2; ++n2)
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            uint32_t r[4];
            ldsm_x4(r, Qs + ((warp * TW + t) * HI + n2 * 16 + lane % 8
                             + (lane / 16) * 8) * LD
                           + ks * 16 + ((lane / 8) % 2) * 8);
            qf[t][2 * n2][ks][0] = r[0];
            qf[t][2 * n2][ks][1] = r[1];
            qf[t][2 * n2 + 1][ks][0] = r[2];
            qf[t][2 * n2 + 1][ks][1] = r[3];
          }
    }
    const bf16* Kst = Ks + (rd % kStages) * kKeys * LD;
    float* Ow = Os + warp * TW * LDO;
    for (int mt = 0; mt < kKeys / 16; ++mt) {
      // scores^T of 16 keys x the warp's tokens' heads, fp32
      float acc[TW][NT][4];
#pragma unroll
      for (int t = 0; t < TW; ++t)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[t][n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t a[4];
        ldsm_x4(a, Kst + (mt * 16 + lane % 16) * LD + ks * 16
                       + (lane / 16) * 8);
#pragma unroll
        for (int t = 0; t < TW; ++t)
#pragma unroll
          for (int n = 0; n < NT; ++n)
            mma16816(acc[t][n], a, qf[t][n][ks][0], qf[t][n][ks][1]);
      }
      // ReLU, scale and weights on the accumulator; the head sum over the
      // thread's columns, then over the quad: keys g and g + 8
#pragma unroll
      for (int t = 0; t < TW; ++t) {
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          s0 = fmaf(wv[t][n][0], fmaxf(acc[t][n][0], 0.f) * scale, s0);
          s0 = fmaf(wv[t][n][1], fmaxf(acc[t][n][1], 0.f) * scale, s0);
          s1 = fmaf(wv[t][n][0], fmaxf(acc[t][n][2], 0.f) * scale, s1);
          s1 = fmaf(wv[t][n][1], fmaxf(acc[t][n][3], 0.f) * scale, s1);
        }
        s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
        s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
        s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
        s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
        if (t4 == 0) Ow[t * LDO + mt * 16 + g] = s0;
        if (t4 == 1) Ow[t * LDO + mt * 16 + g + 8] = s1;
      }
    }
    __syncwarp();
    // the warp's tokens' scores of this round: two 128-byte rows a token
    const int p0 = c0 + rd * kKeys;
#pragma unroll
    for (int t = 0; t < TW; ++t) {
      const int tok = warp * TW + t;
      if (tok >= toks) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = lane + 32 * h;
        if (p0 + j < live) o[(size_t)tok * len + p0 + j] = Ow[t * LDO + j];
      }
    }
    __syncwarp();   // Ow is written again next round
  }
  cp_async_wait<0>();
}

template <int HI, int DI>
cudaError_t configure() {
  static bool done = false;  // once per instantiation
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      span_kernel<HI, DI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Shape<HI, DI>::kSmem);
  done = e == cudaSuccess;
  return e;
}

// over (chunks of the view, token groups, B) CTAs
template <int HI, int DI>
cudaError_t launch(const void* q, const float* w, const void* k, float* out,
                   const PagedKeys& keys, int B, float scale,
                   cudaStream_t stream) {
  using Sh = Shape<HI, DI>;
  cudaError_t e = configure<HI, DI>();
  if (e != cudaSuccess) return e;
  const dim3 grid((keys.len() + kChunk - 1) / kChunk,
                  (keys.S + Sh::kTok - 1) / Sh::kTok, B);
  span_kernel<HI, DI><<<grid, kThreads, Sh::kSmem, stream>>>(
      static_cast<const bf16*>(q), w, static_cast<const bf16*>(k), out, keys,
      scale);
  return cudaGetLastError();
}

// registers, spill bytes, shared memory bytes, CTAs an SM, tokens a CTA
template <int HI, int DI>
cudaError_t resources(int* out) {
  using Sh = Shape<HI, DI>;
  cudaError_t e = configure<HI, DI>();
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, span_kernel<HI, DI>);
  if (e != cudaSuccess) return e;
  int ctas = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &ctas, span_kernel<HI, DI>, kThreads, Sh::kSmem);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)(Sh::kSmem + attr.sharedSizeBytes);
  out[3] = ctas;
  out[4] = Sh::kTok;
  return e;
}

// (heads, index_dim) -> f<HI, DI>(args...) over the instantiated shapes
template <int HI, typename F>
cudaError_t by_dim(int index_dim, F f) {
  switch (index_dim) {
    case 16: return f(std::integral_constant<int, HI>(),
                      std::integral_constant<int, 16>());
    case 32: return f(std::integral_constant<int, HI>(),
                      std::integral_constant<int, 32>());
    case 64: return f(std::integral_constant<int, HI>(),
                      std::integral_constant<int, 64>());
    case 128: return f(std::integral_constant<int, HI>(),
                       std::integral_constant<int, 128>());
    default: return cudaErrorInvalidValue;
  }
}

template <typename F>
cudaError_t by_shape(int heads, int index_dim, F f) {
  if (heads == 16) return by_dim<16>(index_dim, f);
  if (heads == 32) return by_dim<32>(index_dim, f);
  return cudaErrorInvalidValue;
}

}  // namespace span_mma

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
int paged_indexer_scores(int dtype, int index_dim, int block_size,
                         const void* q, const float* w, const void* k_pool,
                         const int* tables, const int* seq_lens, float* out,
                         int B, int heads, int mb, float scale, void* stream) {
  Args a{q, w, k_pool, tables, seq_lens, out, B, 1, heads, mb, block_size,
         scale};
  return run(dtype, index_dim, a, stream);
}

// K6.  q (B, S*Hi, Di) packed rows i*Hi + h; w (B, S*Hi) float32; starts (B,)
// int32 (position of span token 0); out (B, S, mb*bs) float32.
int paged_prefill_indexer(int dtype, int index_dim, int block_size,
                          const void* q, const float* w, const void* k_pool,
                          const int* tables, const int* starts, float* out,
                          int B, int SH, int heads, int mb, float scale,
                          void* stream) {
  if (heads <= 0 || SH % heads) return (int)cudaErrorInvalidValue;
  Args a{q, w, k_pool, tables, starts, out, B, SH / heads, heads, mb,
         block_size, scale};
  if (dtype != 1 || !span_mma::takes(heads, index_dim))
    return run(dtype, index_dim, a, stream);
  if (B <= 0 || a.S <= 0 || mb <= 0 || block_size <= 0)
    return (int)cudaErrorInvalidValue;
  const PagedKeys keys{tables, starts, mb, block_size, a.S};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)span_mma::by_shape(heads, index_dim, [&](auto hi, auto di) {
    return span_mma::launch<decltype(hi)::value, decltype(di)::value>(
        q, w, k_pool, out, keys, B, scale, s);
  });
}

// Resources of the SIMT tile (K5; K6 in fp32 or at other head counts) for
// `dtype`, `index_dim` and `heads` (launches nothing): out[5] = registers
// a thread, spill bytes a thread, shared memory bytes a CTA, CTAs resident
// on one SM, span tokens a CTA.
int paged_indexer_resources(int dtype, int index_dim, int heads, int* out) {
  if (heads <= 0 || heads * index_dim > kQFloats)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)query_dim<float>(index_dim, heads, out);
  if (dtype == 1) return (int)query_dim<__nv_bfloat16>(index_dim, heads, out);
  return (int)cudaErrorInvalidValue;
}

// Resources of K6's bf16 tensor-core body (span_mma) for `heads` and
// `index_dim` (launches nothing; cudaErrorInvalidValue where K6 runs the
// SIMT tile): out[5] as above, the last the span tokens a CTA.
int paged_prefill_indexer_resources(int heads, int index_dim, int* out) {
  if (!span_mma::takes(heads, index_dim)) return (int)cudaErrorInvalidValue;
  return (int)span_mma::by_shape(heads, index_dim, [&](auto hi, auto di) {
    return span_mma::resources<decltype(hi)::value, decltype(di)::value>(out);
  });
}

}  // extern "C"
