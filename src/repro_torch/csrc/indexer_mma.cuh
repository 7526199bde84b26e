// The lightning-indexer score body on Hopper's tensor cores, shared by K6's
// bf16 route (csrc/paged_indexer.cu: a prefill span over the paged index
// keys) and K7's bf16 and fp32 routes (csrc/lightning_indexer.cu: queries
// against contiguous keys, the DSA training chunks and the block
// selector's serve spans), and its decode form, K5's bf16 route
// (decode_kernel below: one token a row over the paged index keys).  K5
// and K6 in fp32 keep indexer_tile.cuh's SIMT tile, as does any head count
// these bodies do not take.
//
// For query token i of batch row b and key position p:
//   out[b, i, p] = sum_h w[b, i, h] * (ReLU(q[b, i, h] . k[p]) * scale)
// q (B, S, Hi, Di) and the keys in T (bf16 or fp32), w (B, S, Hi) and the
// output fp32.  The scores of a span are an (S*Hi) x Di by Di x keys
// product with a ReLU and a weighted head sum after it: arithmetic bound
// (each key's Di values serve S*Hi query rows).
//
// What the body does:
//   * S^T = K Q^T on mma.sync, the heads as the product's N: 16 keys are
//     the A operand, a token's Hi heads the B operand in n-tiles of 8
//     heads (1 at Hi 8, 2 at Hi 16, 4 at Hi 32).  A CTA of 4 warps owns a
//     chunk of kChunk key positions (kRounds rounds of kKeys) and 4 x
//     kTokens tokens; each warp kTokens of them.  The chunk's keys come
//     through a 2-buffer cp.async ring (16-byte copies), each round's
//     copies in flight while the last computes; a position past the live
//     ones (a ragged end, or a dead block) is zero-filled by the copy and
//     never stored;
//   * bf16 (m16n8k16, fp32 accumulate): K by ldmatrix from shared memory;
//     the warp's tokens' queries as B fragments held in registers (at most
//     4096 query values a warp: 64 registers), loaded once a CTA (an
//     ldmatrix .x4 two n-tiles of a k-step, .x2 the one n-tile at Hi 8).
//     bf16 products are exact in fp32.  A key fragment serves every
//     n-tile of every token of the warp: at Hi 8 one n-tile a token, so
//     its reuse is the warp's tokens (4, as at Hi 16: 8 tokens a warp, 2
//     CTAs an SM by registers and shared memory, measured 16 % slower at
//     zamba2's serve span);
//   * fp32 by 3xTF32 (m16n8k8): each fp32 operand is big + small, two TF32
//     values (tf32_tile.cuh's split), and three products big.big +
//     big.small + small.big sum in fp32 accumulators (only small.small,
//     ~2^-22 of a product, is dropped): fp32-level error with TF32 off in
//     the trainer.  The queries are split once, as they are staged, into
//     two uint32 arrays in shared memory; the keys stay fp32 in the ring
//     and are split as a fragment loads.  A k-step's query fragments are
//     read once for all of a round's key tiles (read again for every 16
//     keys, their shared-memory traffic, not the tensor cores, bounds the
//     product); the round's accumulators, at most 64 a thread, cap the
//     tokens a warp.  ldmatrix does not transpose
//     32-bit elements, so the fragments are float2 / uint2 loads under
//     tf32_tile.cuh's permuted k index (k = t of a quad's thread t stands
//     for element 2t of the 8, k = t + 4 for 2t + 1, in A and B alike;
//     rows padded by 8 words, so a half-warp's 16 loads of 8 bytes hit 32
//     distinct banks);
//   * the epilogue works on the accumulator, the same in both: each thread
//     applies ReLU, scale and its heads' weights to its columns (heads
//     n*8 + 2t and + 1) and sums them by fused multiply-adds, two xor
//     shuffles (1, 2) over the quad finish the head sum for keys g and
//     g + 8, and the sums go through shared memory so that a token's
//     scores of a round go out in 128-byte rows.
// Tokens a warp, rounds a CTA and (fp32) keys a round are compile-time
// knobs, REPRO_IDX_TOKENS / REPRO_IDX_ROUNDS for bf16 and
// REPRO_IDX32_TOKENS / REPRO_IDX32_ROUNDS / REPRO_IDX32_KEYS for fp32, so
// tile_study.py can build and time others.
//
// The head counts by form: the span body over paged keys (K6) and over
// dense keys (K7) and the decode form (K5) take 8, 16 or 32 heads
// (takes and by_shape below; at 8 one n-tile of heads, its B fragments
// by an ldmatrix .x2).  K7's fp32 route at 8 heads is the
// 3xTF32 body at one n-tile (2 tokens a warp, as at 16).
//
// The decode form (K5, bf16, S = 1).  The span body puts 4 warps x
// kTokens tokens in a CTA: at one token a row it would leave all but one
// token slot empty.  Here every warp of a CTA takes the row's one token
// and keys of its own: a CTA owns 4 x kDecKeys view positions, 32 a warp
// (two m-tiles of 16 keys as the A operand), copied by cp.async through
// the key policy's staged table; the token's Hi heads are N, their B
// fragments loaded into registers from shared memory; the epilogue is the
// span body's (ReLU, scale, the head weights, the two quad shuffles), and
// a warp's 32 scores go out as one 128-byte row.  One such round a CTA:
// a decode step's ~2300 live positions a row over 8 rows give ~145 CTAs,
// one wave of the card, and their copies are all in flight at once (2 and
// 4 rounds a CTA, a 2-buffer ring, measured 1.3x and 2.1x slower); a
// launch's own latency, not the ~0.7 us of its bytes, is the floor.
//
// Where the keys live is the Keys policy's:
//   kTable            whether the chunk's rows go through a table staged
//                     once a CTA (K6's block table)
//   len()             key positions of a row (the output's last dim)
//   tokens()          span tokens of a row (S)
//   live_end(b)       the first position of row b that is dead: NEG_INF,
//                     never read (past len(): none)
//   stage(b, p0, p1, tab)   (kTable) the table entries of positions
//                     p0 .. p1 - 1 into shared memory
//   row(b, p, p0, tab)      row (in units of Di) of position p's key, p0
//                     the chunk's first position

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tile.cuh"
#include "tf32_tile.cuh"

#ifndef REPRO_IDX_ROUNDS
#define REPRO_IDX_ROUNDS 4
#endif
#ifndef REPRO_IDX_TOKENS
#define REPRO_IDX_TOKENS 4
#endif
#ifndef REPRO_IDX32_ROUNDS
#define REPRO_IDX32_ROUNDS 8
#endif
#ifndef REPRO_IDX32_TOKENS
#define REPRO_IDX32_TOKENS 2
#endif
#ifndef REPRO_IDX32_KEYS
#define REPRO_IDX32_KEYS 64
#endif

namespace {
namespace indexer_mma {

using bf16 = __nv_bfloat16;
using mma_tile::cp_async16;
using mma_tile::cp_async_commit;
using mma_tile::cp_async_wait;
using mma_tile::ldsm_x4;
using mma_tile::mma16816;
using tf32_tile::mma3;
using tf32_tile::split;

// two 8x8 b16 matrices (lanes 0-15 give the rows' addresses)
__device__ inline void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(mma_tile::smem_addr(p)));
}

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;              // key buffers
constexpr int kPad = 8;                 // elements of padding a row
constexpr float kNegInf = -1e30f;       // the reference kernels' NEG_INF

template <typename T>
struct Knobs;
template <>
struct Knobs<bf16> {
  static constexpr int kTokens = REPRO_IDX_TOKENS, kRounds = REPRO_IDX_ROUNDS;
  static constexpr int kKeys = 64;
};
template <>
struct Knobs<float> {
  static constexpr int kTokens = REPRO_IDX32_TOKENS;
  static constexpr int kRounds = REPRO_IDX32_ROUNDS;
  static constexpr int kKeys = REPRO_IDX32_KEYS;
};

template <typename T, int HI, int DI, typename Keys>
struct Shape {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kNT = HI / 8;     // n-tiles of 8 heads
  static constexpr int kKS = DI / 16;    // bf16 k-steps of 16 dims
  static constexpr int kKeys = Knobs<T>::kKeys;   // positions a round
  static constexpr int kChunk = kKeys * Knobs<T>::kRounds;   // a CTA
  // tokens a warp: at most 4096 query values (bf16: 64 registers of
  // pairs; fp32: 32 KB of big and small a warp in shared memory) and, in
  // fp32, at most 64 accumulators a thread for a round's key tiles
  static constexpr int kAccCap = 2048 / (kKeys * HI);   // kKeys/16 x HI/8
  static constexpr int kCap = kF32 && kAccCap < 4096 / (HI * DI)
      ? kAccCap : 4096 / (HI * DI);
  static constexpr int kTokens = kCap < 1 ? 1
      : (kCap > Knobs<T>::kTokens ? Knobs<T>::kTokens : kCap);
  static constexpr int kTok = kWarps * kTokens;   // tokens a CTA
  static constexpr int kLd = DI + kPad;  // row of a query head or key
  static constexpr int kLdO = kKeys + 4;  // fp32 row of staged scores
  // bf16: the queries as bf16; fp32: big and small as uint32
  static constexpr size_t kQBytes =
      (size_t)kTok * HI * kLd * (kF32 ? 8 : 2);
  static constexpr size_t kSmem =
      kQBytes + (size_t)kStages * kKeys * kLd * sizeof(T)
      + (size_t)kTok * kLdO * 4 + (Keys::kTable ? (size_t)(kChunk + 1) * 4
                                                : 0);
  static_assert(HI % 8 == 0 && DI % 16 == 0 && kKeys % 32 == 0,
                "indexer_mma shape");
};

// whether the bodies take (heads, index_dim): 8, 16 or 32 heads (every
// form: K5, K6 and K7); other shapes run the SIMT tile
inline bool takes(int heads, int index_dim) {
  return (heads == 8 || heads == 16 || heads == 32) &&
         index_dim % 16 == 0 && index_dim <= 128;
}

template <typename T, int HI, int DI, typename Keys>
__global__ void __launch_bounds__(kThreads)
span_kernel(const T* __restrict__ q, const float* __restrict__ w,
            const T* __restrict__ k, float* __restrict__ out, Keys keys,
            float scale) {
  using Sh = Shape<T, HI, DI, Keys>;
  constexpr bool F32 = Sh::kF32;
  constexpr int NT = Sh::kNT, TW = Sh::kTokens, KN = Sh::kKeys;
  constexpr int TOK = Sh::kTok, LD = Sh::kLd, LDO = Sh::kLdO;
  constexpr int CH = DI * (int)sizeof(T) / 16;   // 16-byte chunks a row
  constexpr int EL = 16 / (int)sizeof(T);        // elements a chunk

  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem + Sh::kQBytes);  // [kStages][KN][LD]
  float* Os = reinterpret_cast<float*>(Ks + kStages * KN * LD);
  int* Tab = reinterpret_cast<int*>(Os + TOK * LDO);  // kTable only

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int S = keys.tokens(), len = keys.len();
  const int c0 = blockIdx.x * Sh::kChunk;   // the chunk's first position
  const int i0 = blockIdx.y * TOK;          // its first token
  const int b = blockIdx.z;
  const int toks = min(TOK, S - i0);
  const int c_end = min(c0 + Sh::kChunk, len);
  const int live = min(c_end, keys.live_end(b));   // dead from here on
  float* o = out + ((size_t)b * S + i0) * len;

  // the chunk's dead positions: NEG_INF, nothing read
  const int d0 = max(c0, live), n_dead = c_end - d0;
  for (int e = tid; e < toks * n_dead; e += kThreads)
    o[(size_t)(e / n_dead) * len + d0 + e % n_dead] = kNegInf;
  if (live <= c0) return;

  if constexpr (Keys::kTable) keys.stage(b, c0, live, Tab);
  // the CTA's queries; tokens past the span are zero-filled, never written
  const T* qsrc = q + ((size_t)b * S + i0) * HI * DI;
  if constexpr (F32) {   // split into big and small as they are staged
    uint32_t* Qb = reinterpret_cast<uint32_t*>(smem);   // [TOK * HI][LD]
    uint32_t* Qsm = Qb + TOK * HI * LD;
    for (int i = tid; i < TOK * HI * CH; i += kThreads) {
      const int r = i / CH, e = (i % CH) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r / HI < toks)
        x = *reinterpret_cast<const float4*>(qsrc + (size_t)r * DI + e);
      uint4 big, small;
      split(x.x, big.x, small.x);
      split(x.y, big.y, small.y);
      split(x.z, big.z, small.z);
      split(x.w, big.w, small.w);
      *reinterpret_cast<uint4*>(Qb + r * LD + e) = big;
      *reinterpret_cast<uint4*>(Qsm + r * LD + e) = small;
    }
  } else {
    bf16* Qs = reinterpret_cast<bf16*>(smem);            // [TOK * HI][LD]
    for (int i = tid; i < TOK * HI * CH; i += kThreads) {
      const int r = i / CH, e = (i % CH) * EL;
      const bool ok = r / HI < toks;
      cp_async16(Qs + r * LD + e, qsrc + (ok ? (size_t)r * DI + e : 0), ok);
    }
  }
  __syncthreads();   // Tab, and the fp32 queries

  const int rounds = (live - c0 + KN - 1) / KN;
  // round rd's keys into stage rd % kStages; a position past the live
  // ones is zero-filled
  auto issue = [&](int rd) {
    if (rd >= rounds) return;
    const int p0 = c0 + rd * KN;
    T* dst = Ks + (rd % kStages) * KN * LD;
    for (int i = tid; i < KN * CH; i += kThreads) {
      const int j = i / CH, e = (i % CH) * EL, p = p0 + j;
      const bool ok = p < live;
      const size_t row = ok ? keys.row(b, p, c0, Tab) : 0;
      cp_async16(dst + j * LD + e, k + row * DI + e, ok);
    }
  };
  issue(0);
  cp_async_commit();   // the bf16 queries and the first round

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
  // bf16: B fragments of the warp's tokens, loaded once
  uint32_t qf[F32 ? 1 : TW][NT][F32 ? 1 : Sh::kKS][2];

  for (int rd = 0; rd < rounds; ++rd) {
    cp_async_wait<0>();
    // round rd has landed, and every reader of the stage refilled below
    // (round rd - 1's) is done
    __syncthreads();
    issue(rd + 1);
    cp_async_commit();
    if constexpr (!F32) {
      if (rd == 0) {
        const bf16* Qs = reinterpret_cast<const bf16*>(smem);
#pragma unroll
        for (int t = 0; t < TW; ++t)
#pragma unroll
          for (int ks = 0; ks < Sh::kKS; ++ks) {
            const bf16* qt = Qs + (warp * TW + t) * HI * LD + ks * 16
                             + ((lane / 8) % 2) * 8;
            if constexpr (NT == 1) {   // 8 heads: one n-tile, .x2
              uint32_t r[2];
              ldsm_x2(r, qt + (lane % 8) * LD);
              qf[t][0][ks][0] = r[0];
              qf[t][0][ks][1] = r[1];
            } else {
#pragma unroll
              for (int n2 = 0; n2 < NT / 2; ++n2) {
                uint32_t r[4];
                ldsm_x4(r, qt + (n2 * 16 + lane % 8 + (lane / 16) * 8) * LD);
                qf[t][2 * n2][ks][0] = r[0];
                qf[t][2 * n2][ks][1] = r[1];
                qf[t][2 * n2 + 1][ks][0] = r[2];
                qf[t][2 * n2 + 1][ks][1] = r[3];
              }
            }
          }
      }
    }
    const T* Kst = Ks + (rd % kStages) * KN * LD;
    float* Ow = Os + warp * TW * LDO;
    // ReLU, scale and weights on the accumulator of key tile mt; the head
    // sum over the thread's columns, then over the quad: keys g and g + 8
    auto finish = [&](int mt, const float (&acc)[TW][NT][4]) {
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
    };
    if constexpr (F32) {
      // scores^T of the round's KN keys x the warp's tokens' heads: a
      // k-step's query fragments (big and small) are loaded once for all
      // KN / 16 key tiles, each key fragment split once for its tile
      constexpr int MT = KN / 16;
      const uint32_t* Qb = reinterpret_cast<const uint32_t*>(smem);
      const uint32_t* Qsm = Qb + TOK * HI * LD;
      const float* kr = reinterpret_cast<const float*>(Kst) + g * LD + 2 * t4;
      float acc[MT][TW][NT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int t = 0; t < TW; ++t)
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][t][n][e] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < DI; kk += 8) {
        // B: head n*8 + g of token t, dims kk + 2t4 (k = t4) and + 1
        // (k = t4 + 4)
        uint2 bb[TW][NT], bs[TW][NT];
#pragma unroll
        for (int t = 0; t < TW; ++t)
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const int at = ((warp * TW + t) * HI + n * 8 + g) * LD + kk
                           + 2 * t4;
            bb[t][n] = *reinterpret_cast<const uint2*>(Qb + at);
            bs[t][n] = *reinterpret_cast<const uint2*>(Qsm + at);
          }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          // A: keys mt*16 + g and + 8, the same two dims
          const float* km = kr + mt * 16 * LD + kk;
          const float2 x0 = *reinterpret_cast<const float2*>(km);
          const float2 x1 = *reinterpret_cast<const float2*>(km + 8 * LD);
          uint32_t ab[4], as[4];
          split(x0.x, ab[0], as[0]);
          split(x1.x, ab[1], as[1]);
          split(x0.y, ab[2], as[2]);
          split(x1.y, ab[3], as[3]);
#pragma unroll
          for (int t = 0; t < TW; ++t)
#pragma unroll
            for (int n = 0; n < NT; ++n)
              mma3(acc[mt][t][n], ab, as, bb[t][n].x, bb[t][n].y,
                   bs[t][n].x, bs[t][n].y);
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) finish(mt, acc[mt]);
    } else {
      for (int mt = 0; mt < KN / 16; ++mt) {
        // scores^T of 16 keys x the warp's tokens' heads, fp32
        float acc[TW][NT][4];
#pragma unroll
        for (int t = 0; t < TW; ++t)
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[t][n][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < Sh::kKS; ++ks) {
          uint32_t a[4];
          ldsm_x4(a, Kst + (mt * 16 + lane % 16) * LD + ks * 16
                         + (lane / 16) * 8);
#pragma unroll
          for (int t = 0; t < TW; ++t)
#pragma unroll
            for (int n = 0; n < NT; ++n)
              mma16816(acc[t][n], a, qf[t][n][ks][0], qf[t][n][ks][1]);
        }
        finish(mt, acc);
      }
    }
    __syncwarp();
    // the warp's tokens' scores of this round: 128-byte rows a token
    const int p0 = c0 + rd * KN;
#pragma unroll
    for (int t = 0; t < TW; ++t) {
      const int tok = warp * TW + t;
      if (tok >= toks) break;
#pragma unroll
      for (int h = 0; h < KN / 32; ++h) {
        const int j = lane + 32 * h;
        if (p0 + j < live) o[(size_t)tok * len + p0 + j] = Ow[t * LDO + j];
      }
    }
    __syncwarp();   // Ow is written again next round
  }
  cp_async_wait<0>();
}

// once per instantiation (a function-local static: safe when two host
// threads make the first launch at once)
template <typename T, int HI, int DI, typename Keys>
cudaError_t configure() {
  static const cudaError_t e = cudaFuncSetAttribute(
      span_kernel<T, HI, DI, Keys>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Shape<T, HI, DI, Keys>::kSmem);
  return e;
}

// over (chunks of the keys, token groups, B) CTAs
template <typename T, int HI, int DI, typename Keys>
cudaError_t launch(const void* q, const float* w, const void* k, float* out,
                   const Keys& keys, int B, float scale,
                   cudaStream_t stream) {
  using Sh = Shape<T, HI, DI, Keys>;
  cudaError_t e = configure<T, HI, DI, Keys>();
  if (e != cudaSuccess) return e;
  const dim3 grid((keys.len() + Sh::kChunk - 1) / Sh::kChunk,
                  (keys.tokens() + Sh::kTok - 1) / Sh::kTok, B);
  span_kernel<T, HI, DI, Keys><<<grid, kThreads, Sh::kSmem, stream>>>(
      static_cast<const T*>(q), w, static_cast<const T*>(k), out, keys,
      scale);
  return cudaGetLastError();
}

// registers, spill bytes, shared memory bytes, CTAs an SM, tokens a CTA
template <typename T, int HI, int DI, typename Keys>
cudaError_t resources(int* out) {
  using Sh = Shape<T, HI, DI, Keys>;
  cudaError_t e = configure<T, HI, DI, Keys>();
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, span_kernel<T, HI, DI, Keys>);
  if (e != cudaSuccess) return e;
  int ctas = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &ctas, span_kernel<T, HI, DI, Keys>, kThreads, Sh::kSmem);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)(Sh::kSmem + attr.sharedSizeBytes);
  out[3] = ctas;
  out[4] = Sh::kTok;
  return e;
}

// ---------------------------------------------------------------------------
// The decode form: one token a row (K5)
// ---------------------------------------------------------------------------

constexpr int kDecKeys = 32;   // positions a warp: two m-tiles

template <int HI, int DI, typename Keys>
struct DecodeShape {
  static constexpr int kNT = HI / 8;     // n-tiles of 8 heads
  static constexpr int kKS = DI / 16;    // k-steps of 16 dims
  static constexpr int kChunk = kWarps * kDecKeys;   // positions a CTA
  static constexpr int kLd = DI + kPad;  // bf16 row of a head or key
  static constexpr size_t kSmem =
      ((size_t)HI * kLd + (size_t)kChunk * kLd) * 2
      + (size_t)kChunk * 4 + (Keys::kTable ? (size_t)(kChunk + 1) * 4 : 0);
  static_assert(HI % 8 == 0 && DI % 16 == 0, "indexer_mma decode shape");
};

template <int HI, int DI, typename Keys>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const bf16* __restrict__ q, const float* __restrict__ w,
              const bf16* __restrict__ k, float* __restrict__ out,
              Keys keys, float scale) {
  using Sh = DecodeShape<HI, DI, Keys>;
  constexpr int NT = Sh::kNT, KS = Sh::kKS, LD = Sh::kLd;
  constexpr int CH = DI / 8;   // 16-byte chunks a row

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);              // [HI][LD]
  bf16* Ks = Qs + HI * LD;                               // [kChunk][LD]
  float* Os = reinterpret_cast<float*>(Ks + Sh::kChunk * LD);
  int* Tab = reinterpret_cast<int*>(Os + Sh::kChunk);    // kTable only

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int len = keys.len();
  const int c0 = blockIdx.x * Sh::kChunk;   // the CTA's first position
  const int b = blockIdx.y;
  const int c_end = min(c0 + Sh::kChunk, len);
  const int live = min(c_end, keys.live_end(b));   // dead from here on
  float* o = out + (size_t)b * len;

  // the dead positions: NEG_INF, nothing read
  for (int p = max(c0, live) + tid; p < c_end; p += kThreads) o[p] = kNegInf;
  if (live <= c0) return;

  if constexpr (Keys::kTable) {
    keys.stage(b, c0, live, Tab);
    __syncthreads();
  }
  // the token's queries and the CTA's keys; a position past the live
  // ones is zero-filled
  const bf16* qsrc = q + (size_t)b * HI * DI;
  for (int i = tid; i < HI * CH; i += kThreads) {
    const int r = i / CH, e = (i % CH) * 8;
    cp_async16(Qs + r * LD + e, qsrc + (size_t)r * DI + e, true);
  }
  for (int i = tid; i < Sh::kChunk * CH; i += kThreads) {
    const int j = i / CH, e = (i % CH) * 8, p = c0 + j;
    const bool ok = p < live;
    const size_t row = ok ? keys.row(b, p, c0, Tab) : 0;
    cp_async16(Ks + j * LD + e, k + row * DI + e, ok);
  }
  cp_async_commit();

  // this thread's head weights: heads n*8 + 2*t4 and + 1
  float wv[NT][2];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int u = 0; u < 2; ++u)
      wv[n][u] = w[(size_t)b * HI + n * 8 + 2 * t4 + u];
  cp_async_wait<0>();
  __syncthreads();

  // the token's B fragments
  uint32_t qf[NT][KS][2];
  if constexpr (NT == 1) {   // 8 heads: one n-tile, .x2
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t r[2];
      ldsm_x2(r, Qs + (lane % 8) * LD + ks * 16 + ((lane / 8) % 2) * 8);
      qf[0][ks][0] = r[0];
      qf[0][ks][1] = r[1];
    }
  } else {
#pragma unroll
    for (int n2 = 0; n2 < NT / 2; ++n2)
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t r[4];
        ldsm_x4(r, Qs + (n2 * 16 + lane % 8 + (lane / 16) * 8) * LD
                       + ks * 16 + ((lane / 8) % 2) * 8);
        qf[2 * n2][ks][0] = r[0];
        qf[2 * n2][ks][1] = r[1];
        qf[2 * n2 + 1][ks][0] = r[2];
        qf[2 * n2 + 1][ks][1] = r[3];
      }
  }
  // the warp's 32 keys
  const bf16* Kw = Ks + warp * kDecKeys * LD;
  float* Ow = Os + warp * kDecKeys;
#pragma unroll
  for (int mt = 0; mt < kDecKeys / 16; ++mt) {
    // scores^T of 16 keys x the token's heads, fp32
    float acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, Kw + (mt * 16 + lane % 16) * LD + ks * 16 + (lane / 16) * 8);
#pragma unroll
      for (int n = 0; n < NT; ++n)
        mma16816(acc[n], a, qf[n][ks][0], qf[n][ks][1]);
    }
    // ReLU, scale and weights; the head sum over the thread's columns,
    // then over the quad: keys g and g + 8
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s0 = fmaf(wv[n][0], fmaxf(acc[n][0], 0.f) * scale, s0);
      s0 = fmaf(wv[n][1], fmaxf(acc[n][1], 0.f) * scale, s0);
      s1 = fmaf(wv[n][0], fmaxf(acc[n][2], 0.f) * scale, s1);
      s1 = fmaf(wv[n][1], fmaxf(acc[n][3], 0.f) * scale, s1);
    }
    s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
    s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
    if (t4 == 0) Ow[mt * 16 + g] = s0;
    if (t4 == 1) Ow[mt * 16 + g + 8] = s1;
  }
  __syncwarp();
  // the warp's 32 scores: one 128-byte row
  const int p = c0 + warp * kDecKeys + lane;
  if (p < live) o[p] = Ow[lane];
}

template <int HI, int DI, typename Keys>
cudaError_t configure_decode() {
  static bool done = false;  // once per instantiation
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      decode_kernel<HI, DI, Keys>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)DecodeShape<HI, DI, Keys>::kSmem);
  done = e == cudaSuccess;
  return e;
}

// over (chunks of the view, B) CTAs
template <int HI, int DI, typename Keys>
cudaError_t launch_decode(const void* q, const float* w, const void* k,
                          float* out, const Keys& keys, int B, float scale,
                          cudaStream_t stream) {
  using Sh = DecodeShape<HI, DI, Keys>;
  if (B < 1 || B > 65535 || keys.len() < 1) return cudaErrorInvalidValue;
  cudaError_t e = configure_decode<HI, DI, Keys>();
  if (e != cudaSuccess) return e;
  const dim3 grid((keys.len() + Sh::kChunk - 1) / Sh::kChunk, B);
  decode_kernel<HI, DI, Keys><<<grid, kThreads, Sh::kSmem, stream>>>(
      static_cast<const bf16*>(q), w, static_cast<const bf16*>(k), out, keys,
      scale);
  return cudaGetLastError();
}

// registers, spill bytes, shared memory bytes, CTAs an SM, positions a CTA
template <int HI, int DI, typename Keys>
cudaError_t resources_decode(int* out) {
  using Sh = DecodeShape<HI, DI, Keys>;
  cudaError_t e = configure_decode<HI, DI, Keys>();
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, decode_kernel<HI, DI, Keys>);
  if (e != cudaSuccess) return e;
  int ctas = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &ctas, decode_kernel<HI, DI, Keys>, kThreads, Sh::kSmem);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)(Sh::kSmem + attr.sharedSizeBytes);
  out[3] = ctas;
  out[4] = Sh::kChunk;
  return e;
}

// (heads, index_dim) -> f(HI, DI) over the instantiated shapes
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

// over the head counts takes admits
template <typename F>
cudaError_t by_shape(int heads, int index_dim, F f) {
  if (heads == 8) return by_dim<8>(index_dim, f);
  if (heads == 16) return by_dim<16>(index_dim, f);
  if (heads == 32) return by_dim<32>(index_dim, f);
  return cudaErrorInvalidValue;
}

}  // namespace indexer_mma
}  // namespace
