// Causal flash-attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces the three TPU kernels of `flash_attention_bwd` in
// src/repro/kernels/flash_attention/kernel.py (lines 289-375), one
// __global__ kernel each:
//   * bwd_preprocess_kernel  <- `_bwd_preprocess_kernel` (line 197,
//     pallas_call at 310): delta = rowsum(dO * O), fp32;
//   * bwd_dq_kernel          <- `_bwd_dq_kernel` (line 203, pallas_call at
//     326): dQ = scale * sum_k P * (dP - delta) K over the kv tiles up to
//     the diagonal;
//   * bwd_dkv_kernel         <- `_bwd_dkv_kernel` (line 243, pallas_call at
//     348): dV = P^T dO and dK = scale * (P * (dP - delta))^T Q over the q
//     tiles from the diagonal on.
// P = exp(S * scale - lse) is rebuilt in fp32 from the forward's fp32 lse
// (BH, S), with dP = dO V^T.  q, k, v, o, dO are (BH, S, D) in fp32 or
// bf16; dq, dk, dv come out in the input dtype.  Keys at or past
// `valid_len`, keys past the causal diagonal and query rows at or past S
// contribute nothing, so a ragged S needs no padded copy.
//
// What bounds it on the H100: operations, at the tensor cores' TF32 rate.
// The dQ kernel does three and the dK/dV kernel four products of 2 * D
// multiply-adds per (query, key) pair below the diagonal (five distinct
// products, S and dP recomputed in both), against a few (BH, S, D) tensors
// of traffic: at S = 1024, D = 64, hundreds of operations per byte.  Every
// product runs on mma.sync.m16n8k8 TF32 with fp32 accumulation, error-
// compensated: an fp32 operand x is split into hi = tf32(x) (cvt.rna) and
// lo = tf32(x - hi), and a product is a_lo b_hi + a_hi b_lo + a_hi b_hi
// (~2^-21 relative), as PyTorch's memory-efficient fp32 attention does;
// the bound is the TF32 rate (495 TFLOP/s) / 3.  bf16 inputs run through
// the same tile body: a bf16 value is exact in TF32, so its low part is 0
// and only P and dS (fp32, never rounded to bf16) are split; S and dP are
// exact products and P V, dS K, P^T dO, dS^T Q take two.  One body per
// kernel keeps the bf16 instantiation right by construction; it is not
// the bf16 rate.  The delta kernel alone is bytes-bound (two reads of
// (BH, S, D)) and stays as it was: a warp per row on the CUDA cores.
//
// Design.  The TPU carried dq in VMEM scratch across a sequential kv grid
// axis, and dk/dv across a sequential q axis.  Here there is no sequential
// grid: one block of 4 warps owns one (q tile of 64, bh) cell of dQ and
// loops over the kv tiles itself, and one block owns one (kv tile of 64,
// bh) cell of dK/dV and loops over the q tiles itself.  No atomics, so
// results are the same run to run.  Tiles above the diagonal are neither
// loaded nor computed (the TPU clamped its index maps instead).  Each warp
// owns 16 rows of its block's tile (queries in dQ, keys in dK/dV): S (or
// S^T), dP, P, dS and the dq (dk, dv) accumulators live in mma fragments;
// the dK/dV kernel computes S^T = K Q^T and dP^T = V dO^T directly, so no
// fragment is transposed.  P and dS enter the next product from their
// registers as the A operand (the k order within each 8-step is permuted
// to match the accumulator layout; A and B see the same permutation).  The
// tiles the loop walks (dQ: K, V; dK/dV: Q, dO, lse, delta) are copied by
// cp.async into a two-stage ring, so tile t + 1 loads while tile t is in
// the MMAs.  They are the B operands of every product, read by all four
// warps: in fp32 each is split into TF32 hi and lo once, when it lands (by
// the threads that copied it), rather than once per warp and product, so
// the products' inner loops are loads and MMAs alone; the lo halves make
// fp32 walk tiles of 32 (two blocks an SM), bf16 tiles of 64.  The fixed
// A operands (dQ: Q, dO; dK/dV: K, V) are split as they are read, once per
// 8-step for all of a tile's columns.  Each tile's contribution to dq (dk,
// dv) goes to a fresh fragment and is added to the running sum in fp32
// round-to-nearest (add_to): the tensor cores truncate their sums, and the
// bias carried over every tile grew with S.  Rows are padded by 16 bytes
// (D + 4 floats, D + 8 bf16): the scalar fragment loads, along a row (S,
// dP) and down a column (the products with P and dS), are free of bank
// conflicts.
// P is rebuilt with ex2.approx (~2^-22 relative) on scores scaled by
// log2(e) / sqrt(D) in one FMA.  At D = 128 the dK/dV kernel walks q tiles
// of 32 in bf16 too, so its four accumulators fit the registers.  The grids
// run bh fastest and the heaviest tiles first.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <cmath>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;            // query rows per dQ block, 16 per warp
constexpr int BK = 64;            // keys per dK/dV block
constexpr int THREADS = 128;      // 4 warps
constexpr int PRE_THREADS = 256;  // delta kernel: a warp per row
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ---------------------------------------------------------------------------
// copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// global -> shared, zero-filled when !full (nothing is read then)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + ROWS) of one (S, D) head into a tile of row stride ST
// elements; rows at or past s are zero-filled.
template <int ROWS, int D, int ST, typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0,
                                          int s) {
  constexpr int CH = 16 / sizeof(T);  // elements per copy
  constexpr int PER_ROW = D / CH;
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * CH;
    const int row = row0 + r;
    const bool in = row < s;
    cp_async16(dst + r * ST + c, src + (int64_t)(in ? row : 0) * D + c, in);
  }
}

// Entries [row0, row0 + ROWS) of one (S,) row of lse or delta; 0 past s.
template <int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int s, int tid) {
  const int row = row0 + tid;
  if (tid < ROWS) cp_async4(dst + tid, src + (row < s ? row : 0), row < s);
}

// ---------------------------------------------------------------------------
// products: error-compensated TF32 on m16n8k8
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + O(2^-22 |x|), hi and lo TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// An A-operand element as (hi, lo): fp32 split; bf16 exact in TF32, lo = 0.
__device__ __forceinline__ void split_in(float x, uint32_t& hi, uint32_t& lo) {
  split_tf32(x, hi, lo);
}
__device__ __forceinline__ void split_in(bf16 x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(__bfloat162float(x));
  lo = 0u;
}

// Once a streamed fp32 tile (a B operand) has landed, each thread splits
// the 16-byte chunks it copied (load_tile's mapping): TF32 hi in place, lo
// into lo_s.  A thread's own copies are visible to it after cp_wait, so no
// barrier comes before this; the one after it publishes both halves.  The
// products then read B with no conversion, and each element is split once
// rather than once per warp.  bf16 tiles are exact in TF32: nothing to do.
template <int ROWS, int D, int ST>
__device__ __forceinline__ void split_tile(float* x_s, float* lo_s) {
  constexpr int PER_ROW = D / 4;
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += THREADS) {
    const int at = (i / PER_ROW) * ST + (i % PER_ROW) * 4;
    float4 x = *reinterpret_cast<const float4*>(x_s + at);
    uint32_t h[4], l[4];
    split_tf32(x.x, h[0], l[0]);
    split_tf32(x.y, h[1], l[1]);
    split_tf32(x.z, h[2], l[2]);
    split_tf32(x.w, h[3], l[3]);
    *reinterpret_cast<uint4*>(x_s + at) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo_s + at) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}
template <int ROWS, int D, int ST>
__device__ __forceinline__ void split_tile(bf16*, float*) {}

// A B-operand element of a split tile as (hi, lo)
__device__ __forceinline__ void b_elem(const float* x_s, const float* lo_s,
                                       int i, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x_s[i]);
  lo = __float_as_uint(lo_s[i]);
}
__device__ __forceinline__ void b_elem(const bf16* x_s, const float*, int i,
                                       uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(__bfloat162float(x_s[i]));
  lo = 0u;
}

// 2^x (ex2.approx, ~2^-22 relative; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[j] += A B_j for j < N: hi hi, plus lo hi where A has a low part and
// hi lo where B has one, issued a pass over the j at a time (lo hi, hi lo,
// hi hi): the same order into each accumulator, independent MMAs back to
// back.
template <int N, bool A_LO, bool B_LO>
__device__ __forceinline__ void mma_passes(float (&c)[N][4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[N][2],
                                           const uint32_t (&bl)[N][2]) {
  if (A_LO) {
#pragma unroll
    for (int j = 0; j < N; ++j) mma_tf32(c[j], al, bh[j][0], bh[j][1]);
  }
  if (B_LO) {
#pragma unroll
    for (int j = 0; j < N; ++j) mma_tf32(c[j], ah, bl[j][0], bl[j][1]);
  }
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(c[j], ah, bh[j][0], bh[j][1]);
}

// c[j] += A B_j^T for j < NT: A the 16 rows at a_s, B_j rows 8j .. 8j + 7
// of the split tile (b_s, b_lo), both (rows, D) of stride ST.  Fragment
// (g = lane / 4, t = lane % 4): A rows g, g + 8, columns t, t + 4 of each
// 8-step; B row 8j + g, the same columns.  bf16: one exact product a step,
// else three.
template <int D, int ST, int NT, typename T>
__device__ __forceinline__ void mma_rows(float (&c)[NT][4], const T* a_s,
                                         const T* b_s, const float* b_lo,
                                         int g, int t) {
  constexpr bool EXACT = std::is_same<T, bf16>::value;
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) {
    const int k0 = ks * 8 + t;
    uint32_t ah[4], al[4];
    split_in(a_s[g * ST + k0], ah[0], al[0]);
    split_in(a_s[(g + 8) * ST + k0], ah[1], al[1]);
    split_in(a_s[g * ST + k0 + 4], ah[2], al[2]);
    split_in(a_s[(g + 8) * ST + k0 + 4], ah[3], al[3]);
    uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      b_elem(b_s, b_lo, (8 * j + g) * ST + k0, bh[j][0], bl[j][0]);
      b_elem(b_s, b_lo, (8 * j + g) * ST + k0 + 4, bh[j][1], bl[j][1]);
    }
    mma_passes<NT, !EXACT, !EXACT>(c, ah, al, bh, bl);
  }
}

// c[n] += P B for n < D / 8: P (16 x 8 NK, fp32) in accumulator fragments
// (p[j] holds rows g, g + 8 at columns 8j + 2t, 8j + 2t + 1), B rows
// 0 .. 8 NK - 1 of the split tile (b_s, b_lo) (stride ST).  Within each
// 8-step the k order is permuted (k = t -> 2t, k = t + 4 -> 2t + 1) so P
// enters from its registers.  P is always split; bf16 B makes it two
// products.
template <int D, int ST, int NK, typename T>
__device__ __forceinline__ void mma_frag(float (&c)[D / 8][4],
                                         const float (&p)[NK][4],
                                         const T* b_s, const float* b_lo,
                                         int g, int t) {
  constexpr bool EXACT = std::is_same<T, bf16>::value;
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    uint32_t ah[4], al[4];
    split_tf32(p[j][0], ah[0], al[0]);
    split_tf32(p[j][2], ah[1], al[1]);
    split_tf32(p[j][1], ah[2], al[2]);
    split_tf32(p[j][3], ah[3], al[3]);
    const int b = (8 * j + 2 * t) * ST + g;
    uint32_t bh[D / 8][2], bl[D / 8][2];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      b_elem(b_s, b_lo, b + 8 * n, bh[n][0], bl[n][0]);
      b_elem(b_s, b_lo, b + ST + 8 * n, bh[n][1], bl[n][1]);
    }
    mma_passes<D / 8, true, !EXACT>(c, ah, al, bh, bl);
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
}

// acc += part in round-to-nearest fp32.  Each tile's product is taken in a
// fresh accumulator and added here: the tensor cores truncate their sums,
// and a truncation bias carried over every tile of the loop grows with S
// (the cancellation in dS = P (dP - delta) then magnifies it).
template <int NT>
__device__ __forceinline__ void add_to(float (&acc)[NT][4],
                                       const float (&part)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// Streamed tiles: fp32 keeps a lo half beside each (see split_tile), so the
// dQ kernel walks kv tiles of 32 and the dK/dV kernel q tiles of 32, and two
// stages fit beside the fixed tiles with two blocks on an SM; bf16 walks 64
// (32 at D = 128, so the dK/dV kernel's four accumulators fit the
// registers).
template <typename T, int D>
struct Tiles {
  static constexpr bool EXACT = std::is_same<T, bf16>::value;
  static constexpr int PARTS = EXACT ? 1 : 2;  // hi (or bf16), lo
  static constexpr int KN = EXACT ? 64 : 32;   // dQ kernel: keys a tile
  static constexpr int BN = EXACT && D == 64 ? 64 : 32;  // dK/dV: queries
  static constexpr int ST = D + 16 / sizeof(T);  // padded row stride
};

// ---------------------------------------------------------------------------
// kernels
// ---------------------------------------------------------------------------

// delta[row] = sum_d o[row, d] * dout[row, d]; one warp per row.
template <typename T, int D>
__global__ void __launch_bounds__(PRE_THREADS)
bwd_preprocess_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                      float* __restrict__ delta, int64_t rows) {
  const int64_t row =
      (int64_t)blockIdx.x * (PRE_THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // the whole warp shares the row
  float acc = 0.f;
#pragma unroll
  for (int c = lane; c < D; c += 32)
    acc += to_f32(o[row * D + c]) * to_f32(dout[row * D + c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// One block per (bh, q tile): dq for the tile's 64 rows.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int s, int causal, int valid_len,
              float scale_log2, float scale) {
  using TL = Tiles<T, D>;
  constexpr int ST = TL::ST, KN = TL::KN, P = TL::PARTS;
  constexpr int TILE = KN * ST;
  constexpr int NT = KN / 8, NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* do_s = q_s + BQ * ST;
  T* ring = do_s + BQ * ST;  // stage i at ring + 2 P i TILE: K (its lo
                             // after it, fp32), then V (and its lo)

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // diagonal-most tiles first
  const int64_t head = (int64_t)bh * s * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = qt * BQ, w0 = q0 + warp * 16;
  const int row0 = w0 + g;  // this thread's rows: row0, row0 + 8

  // keys this tile's rows may see: [0, kv_end)
  int kv_end = valid_len < s ? valid_len : s;
  if (causal && q0 + BQ < kv_end) kv_end = q0 + BQ;
  const int n_kt = (kv_end + KN - 1) / KN;

  auto load_kv = [&](int kt) {
    T* st = ring + (kt & 1) * 2 * P * TILE;
    load_tile<KN, D, ST>(st, k + head, kt * KN, s);
    load_tile<KN, D, ST>(st + P * TILE, v + head, kt * KN, s);
  };
  load_tile<BQ, D, ST>(q_s, q + head, q0, s);
  load_tile<BQ, D, ST>(do_s, dout + head, q0, s);
  load_kv(0);
  cp_commit();

  float lse2[2], dlt[2];  // the rows' lse (log2 units) and delta
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse2[r] = row < s ? lse[(int64_t)bh * s + row] * LOG2E : 0.f;
    dlt[r] = row < s ? delta[(int64_t)bh * s + row] : 0.f;
  }
  float acc[NO][4];
  zero(acc);

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) {
      load_kv(kt + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    T* k_s = ring + (kt & 1) * 2 * P * TILE;
    T* v_s = k_s + P * TILE;
    float* k_lo = reinterpret_cast<float*>(k_s + TILE);  // fp32 only
    float* v_lo = reinterpret_cast<float*>(v_s + TILE);
    split_tile<KN, D, ST>(k_s, k_lo);
    split_tile<KN, D, ST>(v_s, v_lo);
    __syncthreads();  // tile kt (and at kt = 0 the q and dO tiles) landed

    float sc[NT][4], dp[NT][4];
    zero(sc);
    zero(dp);
    mma_rows<D, ST, NT>(sc, q_s + warp * 16 * ST, k_s, k_lo, g, t);
    mma_rows<D, ST, NT>(dp, do_s + warp * 16 * ST, v_s, v_lo, g, t);

    // sc[j][e]: row row0 + 8 (e / 2), key kv0 + 8j + 2t + (e % 2);
    // becomes dS = P (dP - delta)
    const int kv0 = kt * KN;
    const bool edge = kv0 + KN > kv_end || (causal && kv0 + KN - 1 > w0);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        float x = fmaf(sc[j][e], scale_log2, -lse2[r]);  // <= 0 where valid
        if (edge) {
          const int col = kv0 + 8 * j + 2 * t + (e & 1);
          if (col >= kv_end || (causal && col > row0 + 8 * r)) x = neg_inf();
        }
        sc[j][e] = ex2(x) * (dp[j][e] - dlt[r]);
      }
    }
    float part[NO][4];
    zero(part);
    mma_frag<D, ST, NT>(part, sc, k_s, k_lo, g, t);
    add_to(acc, part);
    __syncthreads();  // every warp is done with this stage before reuse
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row < s) {
      T* out = dq + head + (int64_t)row * D + 2 * t;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        store2(out + 8 * n, acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
    }
  }
}

// One block per (bh, kv tile): dk and dv for the tile's 64 keys.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, int s, int causal,
               int valid_len, float scale_log2, float scale) {
  using TL = Tiles<T, D>;
  constexpr int ST = TL::ST, BN = TL::BN, P = TL::PARTS;
  constexpr int KT = BK * ST, QT = BN * ST;
  constexpr int NT = BN / 8, NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);
  T* v_s = k_s + KT;
  T* ring = v_s + KT;  // stage i at ring + 2 P i QT: Q (its lo after it,
                       // fp32), then dO (and its lo)
  // stage i: lse at rows_s + 2 i BN, delta after it
  float* rows_s = reinterpret_cast<float*>(ring + 4 * P * QT);

  const int bh = blockIdx.x;
  const int kt = blockIdx.y;  // the first kv tiles see the most q tiles
  const int64_t head = (int64_t)bh * s * D;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int w0 = kt * BK + warp * 16;  // the warp's first key
  const int key0 = w0 + g;             // this thread's keys: key0, key0 + 8
  const int kv_valid = valid_len < s ? valid_len : s;

  // q tiles whose rows may see this tile's keys: [qt0, n_qt); none when
  // every key of the tile is at or past valid_len
  const int n_qt = (s + BN - 1) / BN;
  int qt0 = causal ? (kt * BK) / BN : 0;
  if (kt * BK >= kv_valid) qt0 = n_qt;

  auto load_q_tile = [&](int qt, int stage) {
    T* dst = ring + stage * 2 * P * QT;
    load_tile<BN, D, ST>(dst, q + head, qt * BN, s);
    load_tile<BN, D, ST>(dst + P * QT, dout + head, qt * BN, s);
    float* rs = rows_s + stage * 2 * BN;
    if (tid < BN)
      load_rows<BN>(rs, lse + (int64_t)bh * s, qt * BN, s, tid);
    else if (tid < 2 * BN)
      load_rows<BN>(rs + BN, delta + (int64_t)bh * s, qt * BN, s, tid - BN);
  };

  load_tile<BK, D, ST>(k_s, k + head, kt * BK, s);
  load_tile<BK, D, ST>(v_s, v + head, kt * BK, s);
  if (qt0 < n_qt) load_q_tile(qt0, 0);
  cp_commit();

  float dka[NO][4], dva[NO][4];
  zero(dka);
  zero(dva);

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int stage = (qt - qt0) & 1;
    if (qt + 1 < n_qt) {
      load_q_tile(qt + 1, stage ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    T* q_s = ring + stage * 2 * P * QT;
    T* do_s = q_s + P * QT;
    float* q_lo = reinterpret_cast<float*>(q_s + QT);  // fp32 only
    float* do_lo = reinterpret_cast<float*>(do_s + QT);
    split_tile<BN, D, ST>(q_s, q_lo);
    split_tile<BN, D, ST>(do_s, do_lo);
    __syncthreads();  // tile qt (and first the k and v tiles) landed
    const float* lse_s = rows_s + stage * 2 * BN;
    const float* dl_s = lse_s + BN;

    float st[NT][4], dpt[NT][4];  // S^T, dP^T: rows keys, columns queries
    zero(st);
    zero(dpt);
    mma_rows<D, ST, NT>(st, k_s + warp * 16 * ST, q_s, q_lo, g, t);
    mma_rows<D, ST, NT>(dpt, v_s + warp * 16 * ST, do_s, do_lo, g, t);

    // st[j][e]: key key0 + 8 (e / 2), query qt BN + 8j + 2t + (e % 2);
    // st becomes P^T, dpt dS^T
    const int qr0 = qt * BN;
    const bool edge = qr0 + BN > s || w0 + 15 >= kv_valid
                      || (causal && w0 + 15 > qr0);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 lz = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t);
      const float2 dz = *reinterpret_cast<const float2*>(dl_s + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = e & 1;
        float x = fmaf(st[j][e], scale_log2, -(c ? lz.y : lz.x) * LOG2E);
        if (edge) {
          const int qrow = qr0 + 8 * j + 2 * t + c;
          const int key = key0 + 8 * (e / 2);
          if (qrow >= s || key >= kv_valid || (causal && key > qrow))
            x = neg_inf();
        }
        const float p = ex2(x);  // a difference <= 0 where valid
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - (c ? dz.y : dz.x));
      }
    }
    float part[NO][4];
    zero(part);
    mma_frag<D, ST, NT>(part, st, do_s, do_lo, g, t);
    add_to(dva, part);
    zero(part);
    mma_frag<D, ST, NT>(part, dpt, q_s, q_lo, g, t);
    add_to(dka, part);
    __syncthreads();  // every warp is done with this stage before reuse
  }
  cp_wait<0>();  // no copy outlives the block, loop or not

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key < s) {
      const int64_t at = head + (int64_t)key * D + 2 * t;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        store2(dk + at + 8 * n, dka[n][2 * r] * scale,
               dka[n][2 * r + 1] * scale);
        store2(dv + at + 8 * n, dva[n][2 * r], dva[n][2 * r + 1]);
      }
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int D>
cudaError_t launch_preprocess(const void* o, const void* dout, void* delta,
                              int bh, int s, cudaStream_t stream) {
  const int64_t rows = (int64_t)bh * s;
  const int64_t blocks = (rows + PRE_THREADS / 32 - 1) / (PRE_THREADS / 32);
  bwd_preprocess_kernel<T, D><<<(unsigned)blocks, PRE_THREADS, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout),
      static_cast<float*>(delta), rows);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int bh, int s, int causal, int valid_len,
                      cudaStream_t stream) {
  using TL = Tiles<T, D>;
  const size_t smem = sizeof(T) * (2 * BQ + 4 * TL::PARTS * TL::KN) * TL::ST;
  cudaError_t err = allow_smem(bwd_dq_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const float scale = 1.f / std::sqrt((float)D);
  dim3 grid(bh, (s + BQ - 1) / BQ);
  bwd_dq_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), s, causal, valid_len, scale * LOG2E, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int bh, int s, int causal,
                       int valid_len, cudaStream_t stream) {
  using TL = Tiles<T, D>;
  const size_t smem = sizeof(T) * (2 * BK + 4 * TL::PARTS * TL::BN) * TL::ST
                      + sizeof(float) * 4 * TL::BN;
  cudaError_t err = allow_smem(bwd_dkv_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const float scale = 1.f / std::sqrt((float)D);
  dim3 grid(bh, (s + BK - 1) / BK);
  bwd_dkv_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), s, causal, valid_len,
      scale * LOG2E, scale);
  return cudaGetLastError();
}

}  // namespace

// Each entry point: dtype 0 = float32, 1 = bfloat16; d 64 or 128; returns a
// cudaError_t (0 = launched).  valid_len <= 0 means S.
#define DISPATCH(CALL)                                      \
  do {                                                      \
    if (dtype == 0 && d == 64) return (int)CALL(float, 64);   \
    if (dtype == 0 && d == 128) return (int)CALL(float, 128); \
    if (dtype == 1 && d == 64) return (int)CALL(bf16, 64);    \
    if (dtype == 1 && d == 128) return (int)CALL(bf16, 128);  \
    return (int)cudaErrorInvalidValue;                      \
  } while (0)

extern "C" int flash_attention_bwd_preprocess(const void* o, const void* dout,
                                              void* delta, int bh, int s,
                                              int d, int dtype,
                                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PRE(T, D) launch_preprocess<T, D>(o, dout, delta, bh, s, st)
  DISPATCH(PRE);
#undef PRE
}

extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, int bh, int s, int d,
                                      int causal, int valid_len, int dtype,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (valid_len <= 0) valid_len = s;
#define DQ(T, D) \
  launch_dq<T, D>(q, k, v, dout, lse, delta, dq, bh, s, causal, valid_len, st)
  DISPATCH(DQ);
#undef DQ
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int bh, int s,
                                       int d, int causal, int valid_len,
                                       int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (valid_len <= 0) valid_len = s;
#define DKV(T, D)                                                        \
  launch_dkv<T, D>(q, k, v, dout, lse, delta, dk, dv, bh, s, causal,     \
                   valid_len, st)
  DISPATCH(DKV);
#undef DKV
}
