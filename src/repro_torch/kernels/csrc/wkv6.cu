// Chunked RWKV-6 WKV recurrence for Hopper (sm_90a), forward and backward,
// plain C interface.
//
// Replaces the two TPU kernels of src/repro/kernels/rwkv6/kernel.py:
//   * wkv6_fwd <- `_wkv6_kernel` (line 31, pallas_call at 113): per chunk of
//     Q rows, y = (strictly causal pairwise-decayed r.k) v + the
//     current-token bonus (r.(u*k)) v + (r * exp(cum_in)) S, then the (D, D)
//     state S <- diag(exp(cum_last)) S + (k * exp(cum_last - cum))^T v;
//     optionally the state entering each chunk (the backward's residual);
//   * wkv6_bwd <- `_wkv6_bwd_kernel` (line 130, pallas_call at 235): the
//     reverse chunk scan carrying the (D, D) cotangent G of the chunk-final
//     state, seeded from dstate; per chunk dr, dk, dv, d_log_w and du from
//     the saved inputs, the chunk's entry carry S_c and G_c.
// r, k, v are (B, H, S, D) fp32 or bf16, log_w fp32 or r's type, u (H, D)
// fp32, dy and dstate fp32; everything is fp32 inside.  D = 64, 1 <= Q <=
// 64 and S % Q == 0.  cum is the inclusive cumulative log-decay of the
// chunk, per channel, and cum_in = cum - log_w the exclusive one.
//
// What bounds it on the H100.  At 8 x 1024 (H = 64, Q = 64, 8,192 chunks)
// the forward's products come to ~12.9 GFLOP (~39 as three TF32 products,
// ~80 us at 495 TFLOP/s) and its 30,720 exps of differences a chunk to
// 0.25 G on the special-function units, against ~1.6 GB of traffic (r, k,
// v, log_w read by two passes, y, and the (D, D) chunk states written,
// passed and read): ~0.5 ms, bytes.  The backward's ~2.3 GB (~0.7 ms) sits
// above its ~27 GFLOP (~82 as TF32) the same way.  In practice the output
// passes are bound by latency: a warp's chain of loads, exps, splits and
// MMAs with few warps an SM beside it (the backward's 167 KB and ~230
// registers a thread allow one block of 8 warps an SM).
//
// Design: three launches a direction, each over independent work.
//   1. Chunk-local states, grid (b, h, chunk): L_c = (k o exp(cum_last -
//      cum))^T v (forward) or K_c = (r o exp(cum_in))^T dy (backward), (D,
//      D) contractions over the chunk's Q rows, and alpha_c = exp(cum_last)
//      per channel.
//   2. State passing, grid (b, h, slice of the D D cells), elementwise in
//      fp32 round-to-nearest: S_0 = 0, S_{c+1} = diag(alpha_c) S_c + L_c in
//      chunk order, or G_{nc-1} = dstate, G_{c-1} = diag(alpha_c) G_c + K_c
//      in reverse, in place: slot c holds L_c (K_c) on entry and S_c (G_c)
//      on exit.
//   3. Outputs, grid (b, h, chunk): the forward's y from the chunk's inputs
//      and S_c; the backward's every output from the inputs, S_c and G_c,
//      with du per chunk (the wrapper sums the chunks in a fixed order).
// The TPU kernel carried the state across a sequential chunk grid axis;
// the GPU has none, and one block walking a (b, h)'s chunks in order left
// 64 blocks for 132 SMs at a serving prefill.  Here passes 1 and 3 have
// B H nc blocks and only pass 2, one FMA a state cell a chunk, walks the
// chunks in order.  No atomics: two runs give the same bits.
//
// The scores on the tensor cores.  The decay is per channel, so att[i, j]
// = sum_d r_id k_jd exp(cum_in_id - cum_jd) is no masked product of two
// matrices, but it factors across 16-row tiles: for rows i of tile I and
// columns j < s_I = 16 I, with ref_I = cum_in[s_I] = cum[s_I - 1],
//   exp(cum_in_i - cum_j) = exp(cum_in_i - ref_I) exp(ref_I - cum_j),
// both exponents <= 0 since cum falls monotonically: neither factor
// overflows however fast the decay, and where one underflows the true
// product is smaller still.  So an off-diagonal 16 x 16 score tile is
// r'_I k'_I^T with r' = r o exp(cum_in - ref_I), k' = k o exp(ref_I -
// cum), and only the diagonal tiles take an exp of each difference
// (Q (Q - 1) / 2 D of them at Q = 64: 30,720 a chunk instead of 129,024),
// on the CUDA cores (diag_tile: a lane takes two channels of every pair,
// the pairs' partial sums are summed across the lanes 32 pairs at a time).
// The backward's intra-chunk dr and dk factor the same way:
// exp(cum_in_i - ref_I) o ((p o mask) k'_I) and exp(ref_I - cum_j) o
// ((p o mask)^T r'_I), p = dy v^T.  A factored exp(cum_in) exp(-cum) over a
// whole chunk would overflow once log_w reaches -54.6 a token (cum past
// -3,000 in a chunk) and give inf * 0 = NaN.
//
// Arithmetic.  Every product is mma.sync.m16n8k8 TF32 with fp32 operands
// split into hi and lo (three products; bf16 operands that enter unscaled
// are exact in TF32 and skip their lo product), rounded as cvt.rna does by
// integer operations (split_tf32_alu).  The scaled operands r', k', the
// masked score and p tiles stay fp32 and are split, never rounded once.
// The tensor cores truncate their sums, so no MMA accumulator spans more
// than one chunk's rows, and each product with the carried S_c or G_c, and
// each off-diagonal dk part (scaled per column tile), is taken in its own
// accumulator and added in fp32.
//
// Tiles and warps.  A block stages the chunk's (Q, 64) tiles in shared
// memory by 16-byte cp.async (rows past Q zero-filled, so log_w = 0 and k
// = 0 there and the chunk's final cum is row Q - 1's), rows padded by 16
// bytes (68 floats, 72 bf16): a warp's k-major fragment loads (slots k =
// 2t, 2t + 1) fall in distinct banks, its row-major ones in at most two
// ways.  Warp w of a tile-owning group takes 16-row tile w.
// Forward pass 3: 4 warps, one row tile each (scores against every column
// tile, A v, the carried-state term): r, k, v, cum, S_c and the diagonal
// score tiles, 92 KB fp32, two blocks an SM.  Backward pass 3: 8 warps,
// one block an SM (167 KB fp32: r, k, v, dy, cum, S_c, G_c, the diagonal
// dr and dk parts, which turn into the log-decay cotangent's two terms in
// place, and the diagonal p and score tiles).  Warps 0-3 own row tiles
// (p, the diagonal tile on the CUDA cores, dr and its state term); warps
// 4-7 own column tiles (p^T and att^T against every later row tile, dk and
// its state term, dv), computing the transposed tiles themselves rather
// than passing fragments through memory; they take the diagonal tile's
// scores and dk part after a barrier.  A last step of 64 threads turns the
// two cotangent terms into d_log_w by suffix sums over the chunk.
#include <type_traits>

#include "sm90_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int MAX_Q = 64;  // rows of a chunk tile: 4 tiles of 16
constexpr int DIM = 64;    // D
constexpr int CELLS = DIM * DIM;
constexpr int SF = DIM + 4;   // fp32 row stride of the fp32 tiles
constexpr int DT_LD = 17;     // row stride of a 16 x 16 diagonal tile
constexpr int DTILE = 16 * DT_LD;

// the three dtype instances: r, k, v and log_w types
template <int DT> struct Types;
template <> struct Types<0> { using T = float; using TL = float; };
template <> struct Types<1> { using T = bf16; using TL = float; };
template <> struct Types<2> { using T = bf16; using TL = bf16; };

// a tile's row stride in elements, rows padded by 16 bytes
template <typename T>
constexpr int ROW_STRIDE = DIM + 16 / (int)sizeof(T);
// bf16 values are exact in TF32: no lo part, no lo product
template <typename T>
constexpr bool EXACT = std::is_same<T, bf16>::value;

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// exp(x) for x <= 0 as 2^(x log2 e) by ex2.approx.ftz (~2^-22 relative; a
// result below 2^-126 flushes to 0)
__device__ __forceinline__ float exp_le0(float x) {
  return ex2(x * 1.4426950408889634f);
}

// cum_in of row i in channel d: cum of the row before, 0 on the first row
__device__ __forceinline__ float cin(const float* cum, int i, int d) {
  return i > 0 ? cum[(i - 1) * SF + d] : 0.f;
}

// ---------------------------------------------------------------------------
// staging
// ---------------------------------------------------------------------------

// Rows [0, rows) of a (rows, 64) tile from src (row stride 64) into dst
// (row stride ROW_STRIDE<T>); rows at or past `valid` are zero-filled.
template <int THREADS, typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int valid,
                                          int rows) {
  constexpr int CH = 16 / sizeof(T);
  constexpr int PER_ROW = DIM / CH;
  constexpr int ST = ROW_STRIDE<T>;
  for (int i = threadIdx.x; i < rows * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * CH;
    const bool in = r < valid;
    cp_async16(dst + r * ST + c, src + (int64_t)(in ? r : 0) * DIM + c, in);
  }
}

// By the thread of channel d = threadIdx.x < DIM: cum[i][d] = sum_{m <= i}
// log_w[m][d] for every row i < MAX_Q, log_w = 0 past q (so cum stays at
// the chunk's last value there).  The loads are issued before the
// dependent adds.
template <typename TL>
__device__ __forceinline__ void chunk_cum(float* cum, const TL* lw, int q) {
  const int d = threadIdx.x;
  float x[MAX_Q];
#pragma unroll
  for (int i = 0; i < MAX_Q; ++i) x[i] = i < q ? to_f32(lw[i * DIM + d]) : 0.f;
  float run = 0.f;
#pragma unroll
  for (int i = 0; i < MAX_Q; ++i) {
    run += x[i];
    cum[i * SF + d] = run;
  }
}

// ---------------------------------------------------------------------------
// warp products (fragment g = lane / 4, t = lane % 4)
// ---------------------------------------------------------------------------
// Operands are given elementwise as fp32 values, A(m, k) for the warp's 16
// rows m and B(k, n), and split into TF32 hi and lo here.  Within each
// 8-step of k, slot t of the fragments is k = 8 ks + 2 t and slot t + 4 is
// 2 t + 1, the order in which an accumulator fragment holds its columns.

template <int NT, bool A_LO, bool B_LO, typename FA, typename FB>
__device__ __forceinline__ void mma_step(float (&c)[NT][4], int k0, int g,
                                         FA& fa, FB& fb) {
  uint32_t ah[4], al[4], bh[NT][2], bl[NT][2];
  split_tf32_alu(fa(g, k0), ah[0], al[0]);
  split_tf32_alu(fa(g + 8, k0), ah[1], al[1]);
  split_tf32_alu(fa(g, k0 + 1), ah[2], al[2]);
  split_tf32_alu(fa(g + 8, k0 + 1), ah[3], al[3]);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    split_tf32_alu(fb(k0, 8 * n + g), bh[n][0], bl[n][0]);
    split_tf32_alu(fb(k0 + 1, 8 * n + g), bh[n][1], bl[n][1]);
  }
  mma_passes<NT, A_LO, B_LO>(c, ah, al, bh, bl);
}

// c[n] += A B_n for n < NT over K = 8 KS
template <int NT, int KS, bool A_LO, bool B_LO, typename FA, typename FB>
__device__ __forceinline__ void mma_ks(float (&c)[NT][4], int g, int t,
                                       FA fa, FB fb) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    mma_step<NT, A_LO, B_LO>(c, 8 * ks + 2 * t, g, fa, fb);
}

// c[n] += P B_n: P (16 x 8 KT) an accumulator fragment, p[kk] holding rows
// g, g + 8 at columns 8 kk + 2t, 8 kk + 2t + 1; P is always split.
template <int KT, int NT, bool B_LO, typename FB>
__device__ __forceinline__ void mma_frag(float (&c)[NT][4],
                                         const float (&p)[KT][4], int g,
                                         int t, FB fb) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    const int k0 = 8 * kk + 2 * t;
    uint32_t ah[4], al[4], bh[NT][2], bl[NT][2];
    split_tf32_alu(p[kk][0], ah[0], al[0]);
    split_tf32_alu(p[kk][2], ah[1], al[1]);
    split_tf32_alu(p[kk][1], ah[2], al[2]);
    split_tf32_alu(p[kk][3], ah[3], al[3]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      split_tf32_alu(fb(k0, 8 * n + g), bh[n][0], bl[n][0]);
      split_tf32_alu(fb(k0 + 1, 8 * n + g), bh[n][1], bl[n][1]);
    }
    mma_passes<NT, true, B_LO>(c, ah, al, bh, bl);
  }
}

// One stage of sum32: lanes L and L ^ S add their halves of v[0 .. 2S),
// the lower lane keeping v[q], the upper v[q + S], into v[q].  S is a
// template argument so that the loop unrolls and v stays in registers.
template <int S>
__device__ __forceinline__ void sum_stage(float (&v)[32], bool up) {
#pragma unroll
  for (int q = 0; q < S; ++q) {
    const float send = select_reg(up, v[q], v[q + S]);
    const float keep = select_reg(up, v[q + S], v[q]);
    v[q] = keep + __shfl_xor_sync(0xffffffffu, send, S);
  }
}

// v[q] (q < 32) of every lane: on return v[0] of lane L is the sum over the
// lanes of their v[L], in a fixed order (31 shuffles for 32 sums).
__device__ __forceinline__ void sum32(float (&v)[32]) {
  const int lane = threadIdx.x & 31;
  sum_stage<16>(v, lane & 16);
  sum_stage<8>(v, lane & 8);
  sum_stage<4>(v, lane & 4);
  sum_stage<2>(v, lane & 2);
  sum_stage<1>(v, lane & 1);
}

// The diagonal tile of rows base .. base + 15 on the CUDA cores, one exp a
// (pair, channel): att[i][j] = sum_d r_id k_jd exp(cum_in_id - cum_jd) for
// tile rows j < i into att (stride DT_LD; entries on and above the
// diagonal are left as they are).  Lane L takes channels 2L and 2L + 1 of
// each of the 120 pairs, whose partial sums go through sum32 32 pairs at
// a time; the loops unroll fully, so every register index is fixed at
// compile time.  Backward: with p_ij = pd[i][j], also dr[i][d] = sum_{j<i}
// w_ijd k_jd p_ij and dk[j][d] = sum_{i>j} w_ijd r_id p_ij into rows base
// .. of drd, dkd.
template <bool BWD, typename T>
__device__ __forceinline__ void diag_tile(const T* r_s, const T* k_s,
                                          const float* cum, int base,
                                          float* att, const float* pd,
                                          float* drd, float* dkd) {
  constexpr int ST = ROW_STRIDE<T>;
  const int lane = threadIdx.x & 31, d0 = 2 * lane;
  float part[32], dr[16][2], dk[16][2];
#pragma unroll
  for (int q = 0; q < 32; ++q) part[q] = 0.f;
  if constexpr (BWD) {
#pragma unroll
    for (int i = 0; i < 16; ++i) dr[i][0] = dr[i][1] = dk[i][0] = dk[i][1] = 0.f;
  }
#pragma unroll
  for (int i = 1; i < 16; ++i) {
    const float2 ri = load2(r_s + (base + i) * ST + d0);
    const float2 ci = load2(cum + (base + i - 1) * SF + d0);
#pragma unroll
    for (int j = 0; j < 15; ++j) {
      if (j >= i) continue;
      const int n = i * (i - 1) / 2 + j;  // pair index, 0 .. 119
      const float2 kj = load2(k_s + (base + j) * ST + d0);
      const float2 cj = load2(cum + (base + j) * SF + d0);
      const float w0 = exp_le0(ci.x - cj.x), w1 = exp_le0(ci.y - cj.y);
      part[n % 32] = fmaf(ri.x * kj.x, w0, ri.y * kj.y * w1);
      if constexpr (BWD) {
        const float p = pd[i * DT_LD + j];
        dr[i][0] = fmaf(w0 * kj.x, p, dr[i][0]);
        dr[i][1] = fmaf(w1 * kj.y, p, dr[i][1]);
        dk[j][0] = fmaf(w0 * ri.x, p, dk[j][0]);
        dk[j][1] = fmaf(w1 * ri.y, p, dk[j][1]);
      }
      if (n % 32 == 31 || n == 119) {
        sum32(part);
        const int m = n - n % 32 + lane;  // the pair this lane now holds
        if (m <= n) {
          int a = 1;
          while ((a + 1) * a / 2 <= m) ++a;
          att[a * DT_LD + m - a * (a - 1) / 2] = part[0];
        }
      }
    }
  }
  if constexpr (BWD) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      store2(drd + (base + i) * SF + d0, dr[i][0], dr[i][1]);
      store2(dkd + (base + i) * SF + d0, dk[i][0], dk[i][1]);
    }
  }
}

// ---------------------------------------------------------------------------
// pass 1: chunk-local states
// ---------------------------------------------------------------------------

constexpr int P1_THREADS = 128;

template <int DT, bool FWD>
using P1B = std::conditional_t<FWD, typename Types<DT>::T, float>;

template <int DT, bool FWD>
constexpr int p1_smem() {
  using T = typename Types<DT>::T;
  using TB = P1B<DT, FWD>;
  return MAX_Q * ROW_STRIDE<T> * (int)sizeof(T)
         + MAX_Q * ROW_STRIDE<TB> * (int)sizeof(TB) + MAX_Q * SF * 4;
}

// out[b, h, c] = A_c^T B_c (D, D) over the chunk's rows and decay[b, h, c]
// = exp(cum_last) (D).  Forward (FWD): A = k o exp(cum_last - cum), B = v;
// backward: A = r o exp(cum_in), B = dy.  Warp w owns rows d = 16w .. 16w
// + 15 of the result.
template <int DT, bool FWD>
__global__ void __launch_bounds__(P1_THREADS)
wkv6_chunk_state_kernel(const typename Types<DT>::T* __restrict__ a_in,
                        const P1B<DT, FWD>* __restrict__ b_in,
                        const typename Types<DT>::TL* __restrict__ log_w,
                        float* __restrict__ out, float* __restrict__ decay,
                        int S, int Q) {
  using T = typename Types<DT>::T;
  using TB = P1B<DT, FWD>;
  constexpr int SA = ROW_STRIDE<T>, SB = ROW_STRIDE<TB>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* a_s = reinterpret_cast<T*>(smem_raw);
  TB* b_s = reinterpret_cast<TB*>(a_s + MAX_Q * SA);
  float* cum = reinterpret_cast<float*>(b_s + MAX_Q * SB);

  const int nc = S / Q;
  const int64_t row0 =
      (int64_t)(blockIdx.x / nc) * S + (int64_t)(blockIdx.x % nc) * Q;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int ksteps = (Q + 7) / 8;

  load_rows<P1_THREADS>(a_s, a_in + row0 * DIM, Q, 8 * ksteps);
  load_rows<P1_THREADS>(b_s, b_in + row0 * DIM, Q, 8 * ksteps);
  cp_commit();
  if (threadIdx.x < DIM) {
    chunk_cum(cum, log_w + row0 * DIM, Q);
    decay[(int64_t)blockIdx.x * DIM + threadIdx.x] =
        exp_le0(cum[(Q - 1) * SF + threadIdx.x]);
  }
  cp_wait<0>();
  __syncthreads();

  const int dbase = 16 * warp;
  const float* last = cum + (Q - 1) * SF;
  auto fa = [&](int m, int j) {
    const int d = dbase + m;
    float e;
    if constexpr (FWD)
      e = exp_le0(last[d] - cum[j * SF + d]);
    else
      e = exp_le0(cin(cum, j, d));
    return to_f32(a_s[j * SA + d]) * e;
  };
  auto fb = [&](int j, int n) { return to_f32(b_s[j * SB + n]); };
  float acc[DIM / 8][4];
  zero(acc);
#pragma unroll 2
  for (int ks = 0; ks < ksteps; ++ks)
    mma_step<DIM / 8, true, !EXACT<TB>>(acc, 8 * ks + 2 * t, g, fa, fb);
  float* o = out + (int64_t)blockIdx.x * CELLS + (dbase + g) * DIM + 2 * t;
#pragma unroll
  for (int n = 0; n < DIM / 8; ++n) {
    store2(o + 8 * n, acc[n][0], acc[n][1]);
    store2(o + 8 * DIM + 8 * n, acc[n][2], acc[n][3]);
  }
}

// ---------------------------------------------------------------------------
// pass 2: state passing
// ---------------------------------------------------------------------------

constexpr int P2_THREADS = 256;
constexpr int P2_BLOCKS = CELLS / (4 * P2_THREADS);  // blocks per (b, h)

// buf (B H, nc, D D): slot c holds the chunk-local term on entry and the
// state entering chunk c on exit (reverse: the cotangent of the state
// leaving it).  run = init (or 0); per chunk in order (reverse: from the
// last) slot <- run, run <- diag(decay_c) run + the slot's old value; the
// final run goes to final_out where given.  Four cells of one row a
// thread.
__global__ void __launch_bounds__(P2_THREADS)
wkv6_state_pass_kernel(float* __restrict__ buf,
                       const float* __restrict__ decay,
                       const float* __restrict__ init,
                       float* __restrict__ final_out, int nc, int reverse) {
  const int bh = blockIdx.x / P2_BLOCKS;
  const int cell = (blockIdx.x % P2_BLOCKS) * 4 * P2_THREADS
                   + 4 * threadIdx.x;
  const int row = cell / DIM;
  float4 run = make_float4(0.f, 0.f, 0.f, 0.f);
  if (init != nullptr)
    run = *reinterpret_cast<const float4*>(init + (int64_t)bh * CELLS + cell);
  for (int step = 0; step < nc; ++step) {
    const int c = reverse ? nc - 1 - step : step;
    float4* slot = reinterpret_cast<float4*>(
        buf + ((int64_t)bh * nc + c) * CELLS + cell);
    const float4 local = *slot;
    const float alpha = decay[((int64_t)bh * nc + c) * DIM + row];
    *slot = run;
    run.x = fmaf(alpha, run.x, local.x);
    run.y = fmaf(alpha, run.y, local.y);
    run.z = fmaf(alpha, run.z, local.z);
    run.w = fmaf(alpha, run.w, local.w);
  }
  if (final_out != nullptr)
    *reinterpret_cast<float4*>(final_out + (int64_t)bh * CELLS + cell) = run;
}

// ---------------------------------------------------------------------------
// pass 3, forward: y
// ---------------------------------------------------------------------------

constexpr int FWD_THREADS = 128;

template <int DT>
constexpr int fwd_smem() {
  using T = typename Types<DT>::T;
  return 3 * MAX_Q * ROW_STRIDE<T> * (int)sizeof(T) + 2 * MAX_Q * SF * 4
         + 4 * DTILE * 4 + 2 * MAX_Q * 4;
}

// y_i = sum_{j < i} att_ij v_j + (r_i . (u o k_i)) v_i + (r_i o
// exp(cum_in_i)) S_c.  Warp w owns row tile w: its diagonal scores on the
// CUDA cores, r'_w k'^T against every earlier column tile, the products
// with v, and the carried-state term in its own accumulator.
template <int DT>
__global__ void __launch_bounds__(FWD_THREADS, 2)
wkv6_fwd_out_kernel(const typename Types<DT>::T* __restrict__ r,
                    const typename Types<DT>::T* __restrict__ k,
                    const typename Types<DT>::T* __restrict__ v,
                    const typename Types<DT>::TL* __restrict__ log_w,
                    const float* __restrict__ u,
                    const float* __restrict__ states,
                    typename Types<DT>::T* __restrict__ y, int H, int S,
                    int Q) {
  using T = typename Types<DT>::T;
  constexpr int ST = ROW_STRIDE<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* r_s = reinterpret_cast<T*>(smem_raw);
  T* k_s = r_s + MAX_Q * ST;
  T* v_s = k_s + MAX_Q * ST;
  float* cum = reinterpret_cast<float*>(v_s + MAX_Q * ST);
  float* st_s = cum + MAX_Q * SF;   // S_c (D, D)
  float* att = st_s + DIM * SF;     // the 4 diagonal score tiles
  float* bon = att + 4 * DTILE;     // r_i . (u o k_i)
  float* u_s = bon + MAX_Q;

  const int nc = S / Q;
  const int bh = blockIdx.x / nc, h = bh % H;
  const int64_t row0 = (int64_t)bh * S + (int64_t)(blockIdx.x % nc) * Q;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int nt = (Q + 15) / 16;  // row tiles holding the chunk's rows

  load_rows<FWD_THREADS>(r_s, r + row0 * DIM, Q, 16 * nt);
  load_rows<FWD_THREADS>(k_s, k + row0 * DIM, Q, 16 * nt);
  load_rows<FWD_THREADS>(v_s, v + row0 * DIM, Q, 16 * nt);
  load_rows<FWD_THREADS>(st_s, states + (int64_t)blockIdx.x * CELLS, DIM,
                         DIM);
  cp_commit();
  for (int i = threadIdx.x; i < 4 * DTILE; i += FWD_THREADS) att[i] = 0.f;
  if (threadIdx.x < DIM) {
    u_s[threadIdx.x] = u[h * DIM + threadIdx.x];
    chunk_cum(cum, log_w + row0 * DIM, Q);
  }
  cp_wait<0>();
  __syncthreads();
  for (int i = warp; i < 16 * nt; i += FWD_THREADS / 32) {
    float s = 0.f;
    for (int d = lane; d < DIM; d += 32)
      s += to_f32(r_s[i * ST + d]) * u_s[d] * to_f32(k_s[i * ST + d]);
    s = warp_sum(s);
    if (lane == 0) bon[i] = s;
  }
  __syncthreads();

  const int I = warp;
  if (I >= nt) return;
  float* att_i = att + I * DTILE;
  diag_tile<false>(r_s, k_s, cum, 16 * I, att_i, nullptr, nullptr, nullptr);
  __syncwarp();

  auto v_rows = [&](int J) {
    return [=](int j, int n) { return to_f32(v_s[(16 * J + j) * ST + n]); };
  };
  float yacc[DIM / 8][4];
  zero(yacc);
  mma_ks<DIM / 8, 2, true, !EXACT<T>>(
      yacc, g, t, [&](int m, int j) { return att_i[m * DT_LD + j]; },
      v_rows(I));
  if (I > 0) {
    const float* ref = cum + (16 * I - 1) * SF;
#pragma unroll 1
    for (int J = 0; J < I; ++J) {
      float s[2][4];
      zero(s);
      mma_ks<2, DIM / 8, true, true>(
          s, g, t,
          [&](int m, int d) {
            const int i = 16 * I + m;
            return to_f32(r_s[i * ST + d]) * exp_le0(cum[(i - 1) * SF + d] - ref[d]);
          },
          [&](int d, int n) {
            const int j = 16 * J + n;
            return to_f32(k_s[j * ST + d]) * exp_le0(ref[d] - cum[j * SF + d]);
          });
      mma_frag<2, DIM / 8, !EXACT<T>>(yacc, s, g, t, v_rows(J));
    }
  }
  // the carried-state term (r o exp(cum_in)) S_c in its own accumulator
  float ys[DIM / 8][4];
  zero(ys);
  mma_ks<DIM / 8, DIM / 8, true, true>(
      ys, g, t,
      [&](int m, int d) {
        const int i = 16 * I + m;
        return to_f32(r_s[i * ST + d]) * exp_le0(cin(cum, i, d));
      },
      [&](int d, int n) { return st_s[d * SF + n]; });

  T* yb = y + row0 * DIM;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int i = 16 * I + g + 8 * rr;
    if (i >= Q) continue;
    const float b = bon[i];
#pragma unroll
    for (int n = 0; n < DIM / 8; ++n) {
      const int col = 8 * n + 2 * t;
      store2(yb + (int64_t)i * DIM + col,
             fmaf(b, to_f32(v_s[i * ST + col]), yacc[n][2 * rr] + ys[n][2 * rr]),
             fmaf(b, to_f32(v_s[i * ST + col + 1]),
                  yacc[n][2 * rr + 1] + ys[n][2 * rr + 1]));
    }
  }
}

// ---------------------------------------------------------------------------
// pass 3, backward
// ---------------------------------------------------------------------------

constexpr int BWD_THREADS = 256;

template <int DT>
constexpr int bwd_smem() {
  using T = typename Types<DT>::T;
  return 3 * MAX_Q * ROW_STRIDE<T> * (int)sizeof(T)  // r, k, v
         + 6 * MAX_Q * SF * 4       // dy, cum, S_c, G_c, drd, dkd
         + 8 * DTILE * 4            // diagonal score and p tiles
         + 8 * DIM * 4;             // bon, dp, u, sg, kds (4 tiles)
}

// Per chunk, from the inputs, S_c (the carry) and G_c (the cotangent of the
// state leaving the chunk), with p = dy v^T, e_in = exp(cum_in), f =
// exp(cum_last - cum), w_ijd = exp(cum_in_id - cum_jd) (j < i):
//   dv = att^T dy + bonus o dy + (k o f) G_c
//   dr = sum_j w k p + e_in o (dy S_c^T) + u o k o p_ii
//   dk = sum_i w r p + f o (v G_c^T) + u o r o p_ii
//   dcum_in = r o (dr - u k p_ii),  dcum = -k o (dk - u r p_ii), the last
//   row also sum_j k o f o (v G^T) + exp(cum_last) o rowsum(S_c o G_c);
//   d_log_w = suffix sums of dcum + dcum_in, less dcum_in;
//   du_c = sum_i r o k o p_ii.
// Phase 1: row warp I (0-3): p's diagonal tile, the diagonal tile on the
// CUDA cores (scores to att, its dr and dk parts to drd, dkd), p against
// the earlier column tiles and their dr parts, the state term, then dr
// out and dcum_in into drd.  Column warp J (4-7): dk's state term (and its
// share of the last row's sum), then per later row tile I: p^T and att^T,
// dv's and dk's parts.  Phase 2, column warps: the diagonal tile's dv part,
// dk out and dcum into dkd, dv's state term and dv out.  Phase 3: d_log_w
// and du_c by the threads of the 64 channels.
template <int DT>
__global__ void __launch_bounds__(BWD_THREADS, 1)
wkv6_bwd_out_kernel(const typename Types<DT>::T* __restrict__ r,
                    const typename Types<DT>::T* __restrict__ k,
                    const typename Types<DT>::T* __restrict__ v,
                    const typename Types<DT>::TL* __restrict__ log_w,
                    const float* __restrict__ u,
                    const float* __restrict__ carries,
                    const float* __restrict__ gbuf,
                    const float* __restrict__ dy, float* __restrict__ dr,
                    float* __restrict__ dk, float* __restrict__ dv,
                    float* __restrict__ dlw, float* __restrict__ du_c, int H,
                    int S, int Q) {
  using T = typename Types<DT>::T;
  constexpr int ST = ROW_STRIDE<T>;
  constexpr int NT = DIM / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* r_s = reinterpret_cast<T*>(smem_raw);
  T* k_s = r_s + MAX_Q * ST;
  T* v_s = k_s + MAX_Q * ST;
  float* dy_s = reinterpret_cast<float*>(v_s + MAX_Q * ST);
  float* cum = dy_s + MAX_Q * SF;
  float* st_s = cum + MAX_Q * SF;   // S_c (D, D)
  float* g_s = st_s + DIM * SF;     // G_c (D, D)
  float* drd = g_s + DIM * SF;      // dr's diagonal part, then dcum_in
  float* dkd = drd + MAX_Q * SF;    // dk's diagonal part, then dcum
  float* att = dkd + MAX_Q * SF;    // the 4 diagonal score tiles
  float* pd = att + 4 * DTILE;      // the 4 diagonal p tiles
  float* bon = pd + 4 * DTILE;      // r_i . (u o k_i)
  float* dp = bon + DIM;            // p_ii = dy_i . v_i
  float* u_s = dp + DIM;
  float* sg = u_s + DIM;            // rowsum(S_c o G_c)
  float* kds = sg + DIM;            // per column tile: sum_j k o dk_state

  const int nc = S / Q;
  const int bh = blockIdx.x / nc, h = bh % H;
  const int64_t row0 = (int64_t)bh * S + (int64_t)(blockIdx.x % nc) * Q;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int nt = (Q + 15) / 16;

  load_rows<BWD_THREADS>(r_s, r + row0 * DIM, Q, 16 * nt);
  load_rows<BWD_THREADS>(k_s, k + row0 * DIM, Q, 16 * nt);
  load_rows<BWD_THREADS>(v_s, v + row0 * DIM, Q, 16 * nt);
  load_rows<BWD_THREADS>(dy_s, dy + row0 * DIM, Q, 16 * nt);
  load_rows<BWD_THREADS>(st_s, carries + (int64_t)blockIdx.x * CELLS, DIM,
                         DIM);
  load_rows<BWD_THREADS>(g_s, gbuf + (int64_t)blockIdx.x * CELLS, DIM, DIM);
  cp_commit();
  for (int i = threadIdx.x; i < 8 * DTILE; i += BWD_THREADS) att[i] = 0.f;
  if (threadIdx.x < DIM) {
    u_s[threadIdx.x] = u[h * DIM + threadIdx.x];
    chunk_cum(cum, log_w + row0 * DIM, Q);
  }
  cp_wait<0>();
  __syncthreads();
  for (int i = warp; i < 16 * nt; i += BWD_THREADS / 32) {
    float b = 0.f, p = 0.f;
    for (int d = lane; d < DIM; d += 32) {
      b += to_f32(r_s[i * ST + d]) * u_s[d] * to_f32(k_s[i * ST + d]);
      p += dy_s[i * SF + d] * to_f32(v_s[i * ST + d]);
    }
    b = warp_sum(b);
    p = warp_sum(p);
    if (lane == 0) {
      bon[i] = b;
      dp[i] = p;
    }
  }
  for (int d = warp; d < DIM; d += BWD_THREADS / 32) {
    float s = 0.f;
    for (int e = lane; e < DIM; e += 32) s += st_s[d * SF + e] * g_s[d * SF + e];
    s = warp_sum(s);
    if (lane == 0) sg[d] = s;
  }
  __syncthreads();

  const float* last = cum + (Q - 1) * SF;
  // operand views of a tile's rows: as A (m = row, k = channel) and as B
  // of a product with the tile transposed (k = channel, n = row)
  auto dy_rows = [&](int I) {
    return [=](int m, int e) { return dy_s[(16 * I + m) * SF + e]; };
  };
  auto v_rows = [&](int J) {
    return [=](int m, int e) { return to_f32(v_s[(16 * J + m) * ST + e]); };
  };
  auto dy_cols = [&](int I) {
    return [=](int e, int n) { return dy_s[(16 * I + n) * SF + e]; };
  };
  auto v_cols = [&](int J) {
    return [=](int e, int n) { return to_f32(v_s[(16 * J + n) * ST + e]); };
  };
  // r'_I of row tile I as B (k = row i of the tile, n = channel d) and as
  // B^T (k = d, n = i); k'_I of row j of column tile J (m or k = j)
  auto rp = [&](int I, int i, int d) {
    const int ii = 16 * I + i;
    return to_f32(r_s[ii * ST + d])
           * exp_le0(cum[(ii - 1) * SF + d] - cum[(16 * I - 1) * SF + d]);
  };
  auto kp = [&](int I, int J, int j, int d) {
    const int jj = 16 * J + j;
    return to_f32(k_s[jj * ST + d])
           * exp_le0(cum[(16 * I - 1) * SF + d] - cum[jj * SF + d]);
  };

  // ---- phase 1 ----
  float dka[NT][4], dva[NT][4];
  const int J = warp - 4;
  if (warp < 4 && warp < nt) {
    // ---- row warp I ----
    const int I = warp;
    float* pd_i = pd + I * DTILE;
    {
      float p[2][4];
      zero(p);
      mma_ks<2, NT, true, !EXACT<T>>(p, g, t, dy_rows(I), v_cols(I));
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pd_i[(g + 8 * (e >> 1)) * DT_LD + 8 * n + 2 * t + (e & 1)] = p[n][e];
    }
    __syncwarp();
    diag_tile<true>(r_s, k_s, cum, 16 * I, att + I * DTILE, pd_i, drd, dkd);
    // dr's off-diagonal part, exp(cum_in - ref_I) o sum_J (p_IJ k'_IJ)
    float dra[NT][4];
    zero(dra);
#pragma unroll 1
    for (int Jc = 0; Jc < I; ++Jc) {
      float p[2][4];
      zero(p);
      mma_ks<2, NT, true, !EXACT<T>>(p, g, t, dy_rows(I), v_cols(Jc));
      mma_frag<2, NT, true>(dra, p, g, t, [&](int j, int d) {
        return kp(I, Jc, j, d);
      });
    }
    // the carried-state term dy S_c^T in its own accumulator
    float drs[NT][4];
    zero(drs);
    mma_ks<NT, NT, true, true>(drs, g, t, dy_rows(I),
                               [&](int e, int d) { return st_s[d * SF + e]; });
    __syncwarp();  // the diagonal part in drd is this warp's
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int i = 16 * I + g + 8 * rr;
      const float pii = dp[i];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float o[2];
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int d = 8 * n + 2 * t + cc;
          const float ci = cin(cum, i, d);
          float tot = fmaf(drs[n][2 * rr + cc], exp_le0(ci), drd[i * SF + d]);
          if (I > 0)
            tot = fmaf(dra[n][2 * rr + cc],
                       exp_le0(ci - cum[(16 * I - 1) * SF + d]), tot);
          o[cc] = fmaf(u_s[d] * to_f32(k_s[i * ST + d]), pii, tot);
          drd[i * SF + d] = to_f32(r_s[i * ST + d]) * tot;
        }
        if (i < Q) store2(dr + (row0 + i) * DIM + 8 * n + 2 * t, o[0], o[1]);
      }
    }
  } else if (warp >= 4 && J < nt) {
    // ---- column warp J ----
    // dk's state term f o (v G_c^T) in its own accumulator, and its share
    // of the last row's sum_j k o dk_state
    zero(dka);
    mma_ks<NT, NT, !EXACT<T>, true>(dka, g, t, v_rows(J),
                                    [&](int e, int d) { return g_s[d * SF + e]; });
    float ksum[NT][2];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      ksum[n][0] = ksum[n][1] = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 16 * J + g + 8 * (e >> 1), d = 8 * n + 2 * t + (e & 1);
        dka[n][e] *= exp_le0(last[d] - cum[j * SF + d]);
        ksum[n][e & 1] = fmaf(to_f32(k_s[j * ST + d]), dka[n][e], ksum[n][e & 1]);
      }
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        float s = ksum[n][cc];
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 8);
        s += __shfl_xor_sync(0xffffffffu, s, 16);
        if (g == 0) kds[J * DIM + 8 * n + 2 * t + cc] = s;
      }
    }
    zero(dva);
#pragma unroll 1
    for (int I = J + 1; I < nt; ++I) {
      float pt[2][4], at[2][4];
      zero(pt);
      zero(at);
      // p^T: pt[j][i] = v_j . dy_i; att^T: at[j][i] = k'_j . r'_i
      mma_ks<2, NT, !EXACT<T>, true>(pt, g, t, v_rows(J), dy_cols(I));
      mma_ks<2, NT, true, true>(
          at, g, t, [&](int j, int d) { return kp(I, J, j, d); },
          [&](int d, int i) { return rp(I, i, d); });
      mma_frag<2, NT, true>(dva, at, g, t, [&](int i, int e) {
        return dy_s[(16 * I + i) * SF + e];
      });
      // dk's part exp(ref_I - cum_j) o (p^T r'_I), in its own accumulator
      float part[NT][4];
      zero(part);
      mma_frag<2, NT, true>(part, pt, g, t,
                            [&](int i, int d) { return rp(I, i, d); });
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 16 * J + g + 8 * (e >> 1), d = 8 * n + 2 * t + (e & 1);
          dka[n][e] = fmaf(part[n][e],
                           exp_le0(cum[(16 * I - 1) * SF + d] - cum[j * SF + d]),
                           dka[n][e]);
        }
    }
  }
  __syncthreads();

  // ---- phase 2: column warps ----
  if (warp >= 4 && J < nt) {
    const float* att_j = att + J * DTILE;
    // the diagonal tile's att^T dy
    mma_ks<NT, 2, true, true>(
        dva, g, t, [&](int j, int i) { return att_j[i * DT_LD + j]; },
        dy_rows(J));
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int j = 16 * J + g + 8 * rr;
      const float pjj = dp[j];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float o[2];
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int d = 8 * n + 2 * t + cc;
          const float tot = dka[n][2 * rr + cc] + dkd[j * SF + d];
          o[cc] = fmaf(u_s[d] * to_f32(r_s[j * ST + d]), pjj, tot);
          dkd[j * SF + d] = -to_f32(k_s[j * ST + d]) * tot;
        }
        if (j < Q) store2(dk + (row0 + j) * DIM + 8 * n + 2 * t, o[0], o[1]);
      }
    }
    // dv's state term (k o f) G_c in its own accumulator
    float dvs[NT][4];
    zero(dvs);
    mma_ks<NT, NT, true, true>(
        dvs, g, t,
        [&](int j, int d) {
          const int jj = 16 * J + j;
          return to_f32(k_s[jj * ST + d]) * exp_le0(last[d] - cum[jj * SF + d]);
        },
        [&](int d, int e) { return g_s[d * SF + e]; });
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int j = 16 * J + g + 8 * rr;
      if (j >= Q) continue;
      const float b = bon[j];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int col = 8 * n + 2 * t;
        store2(dv + (row0 + j) * DIM + col,
               fmaf(b, dy_s[j * SF + col], dva[n][2 * rr] + dvs[n][2 * rr]),
               fmaf(b, dy_s[j * SF + col + 1],
                    dva[n][2 * rr + 1] + dvs[n][2 * rr + 1]));
      }
    }
  }
  __syncthreads();

  // ---- phase 3: d_log_w by suffix sums, du_c ----
  if (threadIdx.x < DIM) {
    const int d = threadIdx.x;
    float tail = exp_le0(last[d]) * sg[d];
    for (int Jt = 0; Jt < nt; ++Jt) tail += kds[Jt * DIM + d];
    float run = tail, du = 0.f;
#pragma unroll 4
    for (int i = Q - 1; i >= 0; --i) {
      const float dcin = drd[i * SF + d];
      run += dkd[i * SF + d] + dcin;
      dlw[(row0 + i) * DIM + d] = run - dcin;
      du = fmaf(to_f32(r_s[i * ST + d]) * to_f32(k_s[i * ST + d]), dp[i], du);
    }
    du_c[(int64_t)blockIdx.x * DIM + d] = du;
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

cudaError_t launch_state_pass(float* buf, const float* decay,
                              const float* init, float* final_out, int B,
                              int H, int nc, int reverse,
                              cudaStream_t stream) {
  auto kernel = wkv6_state_pass_kernel;
  kernel<<<B * H * P2_BLOCKS, P2_THREADS, 0, stream>>>(buf, decay, init,
                                                       final_out, nc, reverse);
  return cudaGetLastError();
}

template <int DT>
cudaError_t launch_fwd(const void* r, const void* k, const void* v,
                       const void* log_w, const float* u, void* y,
                       float* state, float* states, float* decay, int B,
                       int H, int S, int Q, cudaStream_t stream) {
  using T = typename Types<DT>::T;
  using TL = typename Types<DT>::TL;
  const int blocks = B * H * (S / Q);
  auto p1 = wkv6_chunk_state_kernel<DT, true>;
  constexpr int s1 = p1_smem<DT, true>();
  cudaError_t err = allow_smem(p1, s1);
  if (err != cudaSuccess) return err;
  p1<<<blocks, P1_THREADS, s1, stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const TL*>(log_w), states, decay, S, Q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_state_pass(states, decay, nullptr, state, B, H, S / Q, 0,
                          stream);
  if (err != cudaSuccess) return err;
  auto p3 = wkv6_fwd_out_kernel<DT>;
  constexpr int s3 = fwd_smem<DT>();
  err = allow_smem(p3, s3);
  if (err != cudaSuccess) return err;
  p3<<<blocks, FWD_THREADS, s3, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const TL*>(log_w), u, states,
      static_cast<T*>(y), H, S, Q);
  return cudaGetLastError();
}

template <int DT>
cudaError_t launch_bwd(const void* r, const void* k, const void* v,
                       const void* log_w, const float* u,
                       const float* carries, const float* dy,
                       const float* dstate, float* gbuf, float* decay,
                       float* dr, float* dk, float* dv, float* dlw,
                       float* du_c, int B, int H, int S, int Q,
                       cudaStream_t stream) {
  using T = typename Types<DT>::T;
  using TL = typename Types<DT>::TL;
  const int blocks = B * H * (S / Q);
  auto p1 = wkv6_chunk_state_kernel<DT, false>;
  constexpr int s1 = p1_smem<DT, false>();
  cudaError_t err = allow_smem(p1, s1);
  if (err != cudaSuccess) return err;
  p1<<<blocks, P1_THREADS, s1, stream>>>(
      static_cast<const T*>(r), dy, static_cast<const TL*>(log_w), gbuf,
      decay, S, Q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_state_pass(gbuf, decay, dstate, nullptr, B, H, S / Q, 1,
                          stream);
  if (err != cudaSuccess) return err;
  auto p3 = wkv6_bwd_out_kernel<DT>;
  constexpr int s3 = bwd_smem<DT>();
  err = allow_smem(p3, s3);
  if (err != cudaSuccess) return err;
  p3<<<blocks, BWD_THREADS, s3, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const TL*>(log_w), u, carries,
      gbuf, dy, dr, dk, dv, dlw, du_c, H, S, Q);
  return cudaGetLastError();
}

// the dtype instance of (r's, log_w's) dtype codes, -1 for none
int instance(int dtype, int lw_dtype) {
  if (dtype == 0 && lw_dtype == 0) return 0;
  if (dtype == 1 && lw_dtype == 0) return 1;
  if (dtype == 1 && lw_dtype == 1) return 2;
  return -1;
}

}  // namespace

// Three CUDA launches a call each.  dtype codes: 0 = float32, 1 = bfloat16
// (r, k, v share one; log_w is float32 or r's).  D must be 64, 1 <= Q <=
// 64, S % Q == 0.  The caller allocates the scratch: `states` (B, H, S / Q,
// D, D) fp32 (the carries when it wants them) and `decay` (B, H, S / Q, D)
// fp32; backward `gbuf` (B, H, S / Q, D, D), `decay` and the per-chunk
// `du_c` (B, H, S / Q, D), which the caller sums over the chunks.  Returns
// a cudaError_t (0 = launched).
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v,
                        const void* log_w, const float* u, void* y,
                        float* state, float* states, float* decay, int B,
                        int H, int S, int Q, int dtype, int lw_dtype,
                        void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (Q < 1 || Q > MAX_Q || S % Q != 0) return (int)cudaErrorInvalidValue;
  switch (instance(dtype, lw_dtype)) {
    case 0:
      return launch_fwd<0>(r, k, v, log_w, u, y, state, states, decay, B, H,
                           S, Q, st);
    case 1:
      return launch_fwd<1>(r, k, v, log_w, u, y, state, states, decay, B, H,
                           S, Q, st);
    case 2:
      return launch_fwd<2>(r, k, v, log_w, u, y, state, states, decay, B, H,
                           S, Q, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int wkv6_bwd(const void* r, const void* k, const void* v,
                        const void* log_w, const float* u,
                        const float* carries, const float* dy,
                        const float* dstate, float* gbuf, float* decay,
                        float* dr, float* dk, float* dv, float* dlw,
                        float* du_c, int B, int H, int S, int Q, int dtype,
                        int lw_dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (Q < 1 || Q > MAX_Q || S % Q != 0) return (int)cudaErrorInvalidValue;
  switch (instance(dtype, lw_dtype)) {
    case 0:
      return launch_bwd<0>(r, k, v, log_w, u, carries, dy, dstate, gbuf,
                           decay, dr, dk, dv, dlw, du_c, B, H, S, Q, st);
    case 1:
      return launch_bwd<1>(r, k, v, log_w, u, carries, dy, dstate, gbuf,
                           decay, dr, dk, dv, dlw, du_c, B, H, S, Q, st);
    case 2:
      return launch_bwd<2>(r, k, v, log_w, u, carries, dy, dstate, gbuf,
                           decay, dr, dk, dv, dlw, du_c, B, H, S, Q, st);
  }
  return (int)cudaErrorInvalidValue;
}
