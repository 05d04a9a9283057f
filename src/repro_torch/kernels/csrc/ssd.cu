// Mamba-2 chunked SSD scan for Hopper (sm_90a), forward and backward, plain
// C interface.
//
// Replaces the two TPU kernels of src/repro/kernels/ssd/kernel.py:
//   * ssd_fwd <- `_ssd_kernel` (line 35, pallas_call at 116): per chunk of
//     Q rows, y = (C B^T o decay) (x dt) + exp(cum) (C S), then the (N, P)
//     state S <- exp(cum_Q) S + sum_j exp(cum_Q - cum_j) B_j^T (x dt)_j;
//     optionally the state entering each chunk (the backward's residual);
//   * ssd_bwd <- `_ssd_bwd_kernel` (line 138, pallas_call at 234): the
//     reverse chunk scan carrying the (N, P) cotangent G of the chunk-final
//     state, seeded from dstate; per chunk dx, ddt, dlog and the per-head
//     db_h, dc_h from the saved inputs, the chunk's entry carry and G.
// x is (B, H, S, P) fp32 or bf16, B and C (B, S, N) in x's type and shared
// by the heads, dt (B, H, S) fp32, a (H,) fp32; everything is fp32 inside.
// N = P = 64, Q <= 128 and S % Q == 0.
//
// cum is the inclusive cumulative sum of dt * a over the chunk.  Every
// exponent is taken of a difference, cum_i - cum_j (j <= i), cum_i or
// cum_Q - cum_j, all <= 0, and the state passing multiplies by
// exp(cum_Q) <= 1: a factored exp(cum_i) * exp(-cum_j) overflows once cum
// passes -88 and gives inf * 0 = NaN.
//
// What bounds it on the H100: operations, on the tensor cores.  At 8 x
// 1024 (H = 80, Q = 128, 5,120 chunks) the forward's products come to ~23
// GFLOP with the 16 x 16 tiles above the diagonal skipped, ~68 GFLOP as
// three TF32 products, against ~0.85 GB of traffic (x read twice, y, and
// the (N, P) states written, turned into the carries and read); the
// backward's to ~64 GFLOP, ~191 as TF32, against ~1.35 GB.
//
// Design: three launches a direction, each over independent work.
//   1. Chunk-local states, grid (b, h, chunk):  L_c = B_c^T diag(exp(cum_Q -
//      cum) dt) x_c (forward) or K_c = C_c^T diag(exp(cum)) dy_c (backward),
//      (N, P) contractions over the chunk's Q rows, and exp(cum_Q).
//   2. State passing, grid (b, h, slice of the N P cells), elementwise on
//      the CUDA cores in fp32 round-to-nearest: S_0 = 0, S_{c+1} =
//      exp(cum_Q,c) S_c + L_c in chunk order, or G_{nc-1} = dstate,
//      G_{c-1} = exp(cum_Q,c) G_c + K_c in reverse, in place: slot c of the
//      buffer holds L_c (K_c) on entry and S_c (G_c) on exit.
//   3. Outputs, grid (b, h, chunk): the forward's y from the chunk's inputs
//      and S_c; the backward's every output from the inputs, S_c and G_c.
// The TPU kernel carried the state across a sequential chunk grid axis;
// the GPU has none, and one block walking a (b, h)'s chunks in order left
// 80 blocks for 132 SMs at a serving prefill.  Here passes 1 and 3 have
// B H nc independent blocks and only pass 2, which moves B H nc N P fp32
// cells and does one FMA each, is sequential over chunks.  No pass sums
// across blocks: the reference already made dA a per-position dlog and dB,
// dC per head.  No atomics, so two runs give the same bits.
//
// Arithmetic.  Every product is mma.sync.m16n8k8 TF32 with fp32 operands
// split into hi and lo (three products; bf16 operands are exact in TF32
// and skip their lo product, so C B^T in bf16 is one product).  The split
// rounds as cvt.rna does, by integer operations (split_tf32_alu): the
// products here are bound by the instructions that feed them, and two
// conversions an operand element cost more than the ALU sequence.  The
// decay-masked tiles M = (C B^T) o decay and w = (dy x^T) o decay are
// fp32 in registers, split, never rounded once.  dt is folded into them
// (M_ij dt_j, w_ij dt_j) or into the chunk-state coefficients, so x enters
// the products as it is.  The tensor cores truncate their sums, so no MMA
// accumulator spans more than one chunk's rows (16 k-steps of 8): the sums
// across chunks are pass 2's, in round-to-nearest, and each product with
// the carried state is taken in its own accumulator and added in fp32.
//
// Tiles.  A block stages the chunk's (Q, 64) tiles in shared memory by
// 16-byte cp.async (rows past Q zero-filled; Q need not be a multiple of
// 16), rows padded by 16 bytes (68 floats, 72 bf16) so that the fragment
// loads are free of bank conflicts.  A warp owns 16-row tiles of the chunk
// in pairs (I, 7 - I), so every warp walks 9 16 x 16 tiles of the causal
// triangle, none above the diagonal, with its own tile's A fragments split
// once and held in registers.  Forward pass 3: 4 warps, C, B and x tiles
// (106 KB fp32, two blocks an SM; the carried state is staged transposed
// in x's place before x lands).  Backward pass 3: 8 warps, one block an SM
// (214 KB fp32: C, B, x, dy, S_c, G_c and the dB state term); warps 0-3
// walk row tiles (scores, w, dC) and the dB state term, warps 4-7 column
// tiles (M^T dy, w^T C, dx) and hand off through a named barrier, so
// neither half transposes a fragment through memory.
#include <type_traits>

#include "sm90_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int MAX_Q = 128;  // rows of a chunk tile: 8 tiles of 16
constexpr int DIM = 64;     // N = P
constexpr int CELLS = DIM * DIM;
constexpr int ST32 = DIM + 4;  // fp32 row stride of the state tiles
// columns a warp's 16 rows take on at a step of the causal triangle: the
// scores and w tiles are 16 x TW
constexpr int TW = 16;
constexpr int NS = TW / 8;

// a tile's row stride in elements, rows padded by 16 bytes
template <typename T>
constexpr int ROW_STRIDE = DIM + 16 / (int)sizeof(T);
// bf16 values are exact in TF32: no lo part, no lo product
template <typename T>
constexpr bool EXACT = std::is_same<T, bf16>::value;

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

// By one warp: cum_k = a sum_{m <= k} dt_m over the chunk's q steps into
// CUM, dt into DT, for every k < MAX_Q; dt_k = 0 past q, so cum_k = cum_{q-1}
// there and every exponent stays finite.  Lane L holds k = 4L .. 4L + 3;
// returns cum of those in v.
__device__ __forceinline__ void chunk_cum(const float* dt, float a, int q,
                                          float* CUM, float* DT,
                                          float (&v)[4]) {
  const int lane = threadIdx.x & 31;
  float d[4], run = 0.f;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int k = 4 * lane + r;
    d[r] = k < q ? dt[k] : 0.f;
    run += d[r] * a;
    v[r] = run;
  }
  float tot = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, tot, off);
    if (lane >= off) tot += up;
  }
  const float before = tot - run;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    v[r] += before;
    CUM[4 * lane + r] = v[r];
    DT[4 * lane + r] = d[r];
  }
  __syncwarp();
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// warp products (fragment g = lane / 4, t = lane % 4)
// ---------------------------------------------------------------------------

// One 8-step of k (columns k0 = 8 ks + t and k0 + 4 of this lane) of an
// operand read along k: A's fragment of the 16 rows at a_s (stride SA),
// and B's of rows 8j + g of b_s (stride SB) for j < NT.
template <int SA, typename TA>
__device__ __forceinline__ void frag_a(uint32_t (&ah)[4], uint32_t (&al)[4],
                                       const TA* a_s, int k0, int g) {
  split_in_alu(a_s[g * SA + k0], ah[0], al[0]);
  split_in_alu(a_s[(g + 8) * SA + k0], ah[1], al[1]);
  split_in_alu(a_s[g * SA + k0 + 4], ah[2], al[2]);
  split_in_alu(a_s[(g + 8) * SA + k0 + 4], ah[3], al[3]);
}
template <int NT, int SB, typename TB>
__device__ __forceinline__ void frag_b(uint32_t (&bh)[NT][2],
                                       uint32_t (&bl)[NT][2], const TB* b_s,
                                       int k0, int g) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    split_in_alu(b_s[(8 * j + g) * SB + k0], bh[j][0], bl[j][0]);
    split_in_alu(b_s[(8 * j + g) * SB + k0 + 4], bh[j][1], bl[j][1]);
  }
}

// c[j] += A B_j^T for j < NT over K = 64: A the 16 rows at a_s (stride
// SA), B_j rows 8j .. 8j + 7 of b_s (stride SB), both read along k.
template <int NT, int SA, int SB, typename TA, typename TB>
__device__ __forceinline__ void mma_rr(float (&c)[NT][4], const TA* a_s,
                                       const TB* b_s, int g, int t) {
#pragma unroll
  for (int ks = 0; ks < DIM / 8; ++ks) {
    uint32_t ah[4], al[4], bh[NT][2], bl[NT][2];
    frag_a<SA>(ah, al, a_s, 8 * ks + t, g);
    frag_b<NT, SB>(bh, bl, b_s, 8 * ks + t, g);
    mma_passes<NT, !EXACT<TA>, !EXACT<TB>>(c, ah, al, bh, bl);
  }
}

// A row tile's fragments for every 8-step of K = 64, split once and held
// in registers while its warp walks the causal triangle (bf16: lo unused).
template <typename TA>
struct Held {
  uint32_t hi[DIM / 8][4], lo[DIM / 8][4];
};
template <int SA, typename TA>
__device__ __forceinline__ void hold(Held<TA>& f, const TA* a_s, int g,
                                     int t) {
#pragma unroll
  for (int ks = 0; ks < DIM / 8; ++ks)
    frag_a<SA>(f.hi[ks], f.lo[ks], a_s, 8 * ks + t, g);
}

// mma_rr with A's fragments held
template <int NT, int SB, typename TA, typename TB>
__device__ __forceinline__ void mma_hr(float (&c)[NT][4], const Held<TA>& a,
                                       const TB* b_s, int g, int t) {
#pragma unroll
  for (int ks = 0; ks < DIM / 8; ++ks) {
    uint32_t bh[NT][2], bl[NT][2];
    frag_b<NT, SB>(bh, bl, b_s, 8 * ks + t, g);
    mma_passes<NT, !EXACT<TA>, !EXACT<TB>>(c, a.hi[ks], a.lo[ks], bh, bl);
  }
}

// c[j] += A B_j for j < NT over K = 64: A's fragments held, B element
// (k, n) = b_s[k SB + n] (k-major).
template <int NT, int SB, typename TA, typename TB>
__device__ __forceinline__ void mma_hk(float (&c)[NT][4], const Held<TA>& a,
                                       const TB* b_s, int g, int t) {
#pragma unroll
  for (int ks = 0; ks < DIM / 8; ++ks) {
    const int k0 = ks * 8 + t;
    uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      split_in_alu(b_s[k0 * SB + 8 * j + g], bh[j][0], bl[j][0]);
      split_in_alu(b_s[(k0 + 4) * SB + 8 * j + g], bh[j][1], bl[j][1]);
    }
    mma_passes<NT, !EXACT<TA>, !EXACT<TB>>(c, a.hi[ks], a.lo[ks], bh, bl);
  }
}

// c[n] += P B for n < NT: P (16 x 8 KT, fp32) in accumulator fragments
// (p[j] holds rows g, g + 8 at columns 8j + 2t, 8j + 2t + 1), B element
// (k, n) = b_s[k SB + n] for k < 8 KT.  Within each 8-step the k order is
// permuted (k = t -> 2t, k = t + 4 -> 2t + 1) so P enters from its
// registers; P is always split.
template <int KT, int NT, int SB, typename TB>
__device__ __forceinline__ void mma_fr(float (&c)[NT][4],
                                       const float (&p)[KT][4],
                                       const TB* b_s, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    uint32_t ah[4], al[4];
    split_tf32_alu(p[kk][0], ah[0], al[0]);
    split_tf32_alu(p[kk][2], ah[1], al[1]);
    split_tf32_alu(p[kk][1], ah[2], al[2]);
    split_tf32_alu(p[kk][3], ah[3], al[3]);
    const TB* b = b_s + (8 * kk + 2 * t) * SB + g;
    uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      split_in_alu(b[8 * n], bh[n][0], bl[n][0]);
      split_in_alu(b[SB + 8 * n], bh[n][1], bl[n][1]);
    }
    mma_passes<NT, true, !EXACT<TB>>(c, ah, al, bh, bl);
  }
}

// ---------------------------------------------------------------------------
// pass 1: chunk-local states
// ---------------------------------------------------------------------------

constexpr int P1_THREADS = 128;

template <typename TU, typename TV>
constexpr int p1_smem() {
  return MAX_Q * ROW_STRIDE<TU> * (int)sizeof(TU)
         + MAX_Q * ROW_STRIDE<TV> * (int)sizeof(TV) + 2 * MAX_Q * 4;
}

// out[b, h, c] = U_c^T diag(coef) V_c (N, P) over the chunk's rows, and
// decay[b, h, c] = exp(cum_Q).  Forward (FWD): U = B, V = x, coef_j =
// exp(cum_Q - cum_j) dt_j; backward: U = C, V = dy, coef_i = exp(cum_i).
// Warp w owns rows n = 16w .. 16w + 15 of the result.
template <typename TU, typename TV, bool FWD>
__global__ void __launch_bounds__(P1_THREADS)
ssd_chunk_state_kernel(const TU* __restrict__ u_in,
                       const TV* __restrict__ v_in,
                       const float* __restrict__ dt,
                       const float* __restrict__ a_coef,
                       float* __restrict__ out, float* __restrict__ decay,
                       int H, int S, int Q) {
  constexpr int SU = ROW_STRIDE<TU>, SV = ROW_STRIDE<TV>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TU* u_s = reinterpret_cast<TU*>(smem_raw);
  TV* v_s = reinterpret_cast<TV*>(u_s + MAX_Q * SU);
  float* CUM = reinterpret_cast<float*>(v_s + MAX_Q * SV);
  float* COEF = CUM + MAX_Q;

  const int nc = S / Q;
  const int c = blockIdx.x % nc, bh = blockIdx.x / nc;
  const int b = bh / H, h = bh % H;
  const int s0 = c * Q;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int ksteps = (Q + 7) / 8;

  load_rows<P1_THREADS>(u_s, u_in + ((int64_t)b * S + s0) * DIM, Q,
                        8 * ksteps);
  load_rows<P1_THREADS>(v_s, v_in + ((int64_t)bh * S + s0) * DIM, Q,
                        8 * ksteps);
  cp_commit();
  if (warp == 0) {
    float v[4];
    chunk_cum(dt + (int64_t)bh * S + s0, a_coef[h], Q, CUM, COEF, v);
    const float cum_q = CUM[Q - 1];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = 4 * lane + r;
      COEF[k] = FWD ? expf(cum_q - v[r]) * COEF[k] : expf(v[r]);
    }
    if (lane == 0) decay[blockIdx.x] = expf(cum_q);
  }
  cp_wait<0>();
  __syncthreads();

  float acc[DIM / 8][4];
  zero(acc);
  const TU* a_s = u_s + 16 * warp;
  for (int ks = 0; ks < ksteps; ++ks) {
    const int ka = 8 * ks + 2 * t;  // k = t -> 2t, k = t + 4 -> 2t + 1
    const float ca = COEF[ka], cb = COEF[ka + 1];
    uint32_t ah[4], al[4];
    split_tf32_alu(to_f32(a_s[ka * SU + g]) * ca, ah[0], al[0]);
    split_tf32_alu(to_f32(a_s[ka * SU + g + 8]) * ca, ah[1], al[1]);
    split_tf32_alu(to_f32(a_s[(ka + 1) * SU + g]) * cb, ah[2], al[2]);
    split_tf32_alu(to_f32(a_s[(ka + 1) * SU + g + 8]) * cb, ah[3], al[3]);
    const TV* bp = v_s + ka * SV + g;
    uint32_t bh_[DIM / 8][2], bl_[DIM / 8][2];
#pragma unroll
    for (int n = 0; n < DIM / 8; ++n) {
      split_in_alu(bp[8 * n], bh_[n][0], bl_[n][0]);
      split_in_alu(bp[SV + 8 * n], bh_[n][1], bl_[n][1]);
    }
    mma_passes<DIM / 8, true, !EXACT<TV>>(acc, ah, al, bh_, bl_);
  }
  float* o = out + (int64_t)blockIdx.x * CELLS + (16 * warp + g) * DIM + 2 * t;
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

// buf (B H, nc, N P): slot c holds the chunk-local term on entry and the
// state entering chunk c on exit (reverse: the cotangent of the state
// leaving it).  run = init (or 0); per chunk in order (reverse: from the
// last) slot <- run, run <- decay_c run + the slot's old value; the final
// run goes to final_out where given.  Four cells a thread.
__global__ void __launch_bounds__(P2_THREADS)
ssd_state_pass_kernel(float* __restrict__ buf,
                      const float* __restrict__ decay,
                      const float* __restrict__ init,
                      float* __restrict__ final_out, int nc, int reverse) {
  const int bh = blockIdx.x / P2_BLOCKS;
  const int cell = (blockIdx.x % P2_BLOCKS) * 4 * P2_THREADS
                   + 4 * threadIdx.x;
  float4 run = make_float4(0.f, 0.f, 0.f, 0.f);
  if (init != nullptr)
    run = *reinterpret_cast<const float4*>(init + (int64_t)bh * CELLS + cell);
  for (int step = 0; step < nc; ++step) {
    const int c = reverse ? nc - 1 - step : step;
    float4* slot = reinterpret_cast<float4*>(
        buf + ((int64_t)bh * nc + c) * CELLS + cell);
    const float4 local = *slot;
    const float alpha = decay[(int64_t)bh * nc + c];
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

template <typename T>
constexpr int fwd_smem() {
  return 3 * MAX_Q * ROW_STRIDE<T> * (int)sizeof(T) + 3 * MAX_Q * 4;
}

// y_i = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j + exp(cum_i)
// C_i S_c for the chunk's rows.  Warp w owns row tiles w and 7 - w.
template <typename T>
__global__ void __launch_bounds__(FWD_THREADS, 2)
ssd_fwd_out_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ a_coef,
                   const T* __restrict__ b_in, const T* __restrict__ c_in,
                   const float* __restrict__ states, T* __restrict__ y,
                   int H, int S, int Q) {
  constexpr int ST = ROW_STRIDE<T>;
  static_assert(MAX_Q * ST * sizeof(T) >= DIM * ST32 * 4,
                "the state fits in x's tile");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* c_s = reinterpret_cast<T*>(smem_raw);
  T* b_s = c_s + MAX_Q * ST;
  T* x_s = b_s + MAX_Q * ST;
  float* st_s = reinterpret_cast<float*>(x_s);  // S_c^T (P, N) until x lands
  float* CUM = reinterpret_cast<float*>(x_s + MAX_Q * ST);
  float* DT = CUM + MAX_Q;
  float* E = DT + MAX_Q;

  const int nc = S / Q;
  const int c = blockIdx.x % nc, bh = blockIdx.x / nc;
  const int b = bh / H, h = bh % H;
  const int s0 = c * Q;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int nt = (Q + 15) / 16;  // row tiles holding the chunk's rows

  load_rows<FWD_THREADS>(c_s, c_in + ((int64_t)b * S + s0) * DIM, Q, 16 * nt);
  load_rows<FWD_THREADS>(b_s, b_in + ((int64_t)b * S + s0) * DIM, Q, 16 * nt);
  cp_commit();
  const float* st = states + (int64_t)blockIdx.x * CELLS;
  for (int i = threadIdx.x; i < CELLS; i += FWD_THREADS)
    st_s[(i % DIM) * ST32 + i / DIM] = st[i];
  if (warp == 0) {
    float v[4];
    chunk_cum(dt + (int64_t)bh * S + s0, a_coef[h], Q, CUM, DT, v);
#pragma unroll
    for (int r = 0; r < 4; ++r) E[4 * lane + r] = expf(v[r]);
  }
  cp_wait<0>();
  __syncthreads();

  const int tiles[2] = {warp, 7 - warp};
  // the carried-state term of both row tiles: C_I S_c, in its own
  // accumulator
  float inter[2][DIM / 8][4];
  zero(inter[0]);
  zero(inter[1]);
  {
    const T* a0 = c_s + 16 * tiles[0] * ST;
    const T* a1 = c_s + 16 * tiles[1] * ST;
#pragma unroll
    for (int ks = 0; ks < DIM / 8; ++ks) {  // S^T's fragments split once
      uint32_t ah[4], al[4], bh[DIM / 8][2], bl[DIM / 8][2];
      frag_b<DIM / 8, ST32>(bh, bl, st_s, 8 * ks + t, g);
      frag_a<ST>(ah, al, a0, 8 * ks + t, g);
      mma_passes<DIM / 8, !EXACT<T>, true>(inter[0], ah, al, bh, bl);
      frag_a<ST>(ah, al, a1, 8 * ks + t, g);
      mma_passes<DIM / 8, !EXACT<T>, true>(inter[1], ah, al, bh, bl);
    }
  }
  __syncthreads();  // every warp is done with the state: x may land there
  load_rows<FWD_THREADS>(x_s, x + ((int64_t)bh * S + s0) * DIM, Q, 16 * nt);
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  T* yb = y + ((int64_t)bh * S + s0) * DIM;
#pragma unroll  // inter[u] stays in registers
  for (int u = 0; u < 2; ++u) {
    const int I = tiles[u];
    if (I >= nt) continue;
    const int i0 = 16 * I + g;  // this thread's rows: i0, i0 + 8
    float yacc[DIM / 8][4];
    zero(yacc);
    Held<T> cf;  // C_I
    hold<ST>(cf, c_s + 16 * I * ST, g, t);
#pragma unroll 1
    for (int j0 = 0; j0 < 16 * I + 16; j0 += TW) {
      float m[NS][4];
      zero(m);
      mma_hr<NS, ST>(m, cf, b_s + j0 * ST, g, t);
#pragma unroll
      for (int jt = 0; jt < NS; ++jt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + 8 * (e >> 1);
          const int j = j0 + 8 * jt + 2 * t + (e & 1);
          m[jt][e] = j <= i ? m[jt][e] * expf(CUM[i] - CUM[j]) * DT[j] : 0.f;
        }
      mma_fr<NS, DIM / 8, ST>(yacc, m, x_s + j0 * ST, g, t);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + 8 * r;
      if (i >= Q) continue;
      const float e = E[i];
      T* row = yb + (int64_t)i * DIM + 2 * t;
#pragma unroll
      for (int n = 0; n < DIM / 8; ++n)
        store2(row + 8 * n, fmaf(e, inter[u][n][2 * r], yacc[n][2 * r]),
               fmaf(e, inter[u][n][2 * r + 1], yacc[n][2 * r + 1]));
    }
  }
}

// ---------------------------------------------------------------------------
// pass 3, backward
// ---------------------------------------------------------------------------

constexpr int BWD_THREADS = 256;
constexpr int NROW = 9;  // per-row arrays: CUM DT E F ROW COL T2 U DOT

template <typename T>
constexpr int bwd_smem() {
  return 3 * MAX_Q * ROW_STRIDE<T> * (int)sizeof(T)
         + 2 * MAX_Q * ST32 * 4 + 2 * DIM * ST32 * 4 + NROW * MAX_Q * 4
         + 8 * 4;
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Per chunk, from the inputs, S_c (the carry) and G_c (the cotangent of the
// state leaving the chunk), with decay_ij = exp(cum_i - cum_j) for j <= i,
// scores = C B^T, w = decay o (dy x^T) diag(dt), M = scores o decay:
//   dxdt = M^T dy + f o (B G),  dx = dxdt dt,  f_j = exp(cum_Q - cum_j)
//   dc = w B + e o (dy S^T),    e_i = exp(cum_i)
//   db = w^T C + f dt o (x G^T)
//   dcum = rowsum(t) - colsum(t) + t2 - u, t = scores o w, t2_i = C_i .
//   (e_i dy_i S^T), u_j = B_j . (f_j dt_j x_j G^T); the last row also
//   sum_j u_j + exp(cum_Q) <S_c, G_c>; dlog = suffix sums of dcum;
//   ddt = a dlog + sum_p dxdt x.
// Warps 0-3 (row tiles I in pairs): the dB state term of tiles I into DBS
// and u, <S, G>, then per I: scores and w against every J <= I, rowsum(t),
// dc.  Warps 4-7 (column tiles J in pairs): per J, M^T and w^T against
// every I >= J, colsum(t), dx, sum_p dxdt x, and db with DBS added.
template <typename T>
__global__ void __launch_bounds__(BWD_THREADS, 1)
ssd_bwd_out_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ a_coef,
                   const T* __restrict__ b_in, const T* __restrict__ c_in,
                   const float* __restrict__ carries,
                   const float* __restrict__ gbuf,
                   const float* __restrict__ dy, float* __restrict__ dx,
                   float* __restrict__ ddt, float* __restrict__ dlog,
                   float* __restrict__ db_h, float* __restrict__ dc_h, int H,
                   int S, int Q) {
  constexpr int ST = ROW_STRIDE<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* c_s = reinterpret_cast<T*>(smem_raw);
  T* b_s = c_s + MAX_Q * ST;
  T* x_s = b_s + MAX_Q * ST;
  float* dy_s = reinterpret_cast<float*>(x_s + MAX_Q * ST);  // (Q, 68)
  float* dbs_s = dy_s + MAX_Q * ST32;  // dB's state term (Q, 68)
  float* s_s = dbs_s + MAX_Q * ST32;   // S_c (N, 68)
  float* g_s = s_s + DIM * ST32;       // G_c (N, 68)
  float* CUM = g_s + DIM * ST32;
  float* DT = CUM + MAX_Q;
  float* E = DT + MAX_Q;
  float* F = E + MAX_Q;
  float* ROW = F + MAX_Q;
  float* COL = ROW + MAX_Q;
  float* T2 = COL + MAX_Q;
  float* U = T2 + MAX_Q;
  float* DOT = U + MAX_Q;
  float* SGW = DOT + MAX_Q;  // per row warp: its share of <S_c, G_c>

  const int nc = S / Q;
  const int c = blockIdx.x % nc, bh = blockIdx.x / nc;
  const int b = bh / H, h = bh % H;
  const int s0 = c * Q;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int nt = (Q + 15) / 16;
  const float a = a_coef[h];
  const int64_t row0 = (int64_t)bh * S + s0;  // the chunk's first (b, h) row

  load_rows<BWD_THREADS>(c_s, c_in + ((int64_t)b * S + s0) * DIM, Q, 16 * nt);
  load_rows<BWD_THREADS>(b_s, b_in + ((int64_t)b * S + s0) * DIM, Q, 16 * nt);
  load_rows<BWD_THREADS>(x_s, x + row0 * DIM, Q, 16 * nt);
  load_rows<BWD_THREADS>(dy_s, dy + row0 * DIM, Q, 16 * nt);
  load_rows<BWD_THREADS>(s_s, carries + (int64_t)blockIdx.x * CELLS, DIM, DIM);
  load_rows<BWD_THREADS>(g_s, gbuf + (int64_t)blockIdx.x * CELLS, DIM, DIM);
  cp_commit();
  if (warp == 0) {
    float v[4];
    chunk_cum(dt + row0, a, Q, CUM, DT, v);
    const float cum_q = CUM[Q - 1];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      E[4 * lane + r] = expf(v[r]);
      F[4 * lane + r] = expf(cum_q - v[r]);
    }
  }
  cp_wait<0>();
  __syncthreads();

  if (warp < 4) {
    // ---- row warps: the dB state term, <S, G>, then scores, w, dc ----
    const int tiles[2] = {warp, 7 - warp};
#pragma unroll 1
    for (int u = 0; u < 2; ++u) {
      const int J = tiles[u];
      if (J >= nt) continue;
      float dbs[DIM / 8][4];
      zero(dbs);
      mma_rr<DIM / 8, ST, ST32>(dbs, x_s + 16 * J * ST, g_s, g, t);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = 16 * J + g + 8 * r;
        const float fd = F[j] * DT[j];
        float us = 0.f;
#pragma unroll
        for (int n = 0; n < DIM / 8; ++n) {
          const int col = 8 * n + 2 * t;
          const float d0 = fd * dbs[n][2 * r], d1 = fd * dbs[n][2 * r + 1];
          store2(dbs_s + j * ST32 + col, d0, d1);
          us += to_f32(b_s[j * ST + col]) * d0
                + to_f32(b_s[j * ST + col + 1]) * d1;
        }
        us = quad_sum(us);
        if (t == 0) U[j] = us;
      }
    }
    float sg = 0.f;
    for (int i = threadIdx.x; i < CELLS; i += 128) {
      const int at = (i / DIM) * ST32 + i % DIM;
      sg += s_s[at] * g_s[at];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sg += __shfl_xor_sync(0xffffffffu, sg, off);
    if (lane == 0) SGW[warp] = sg;
    __threadfence_block();
    bar_arrive(1, BWD_THREADS);  // DBS is written

#pragma unroll 1
    for (int u = 0; u < 2; ++u) {
      const int I = tiles[u];
      if (I >= nt) continue;
      const int i0 = 16 * I + g;
      float dc[DIM / 8][4];
      zero(dc);
      float rs[2] = {0.f, 0.f};
      Held<T> cf;      // C_I
      Held<float> df;  // dy_I
      hold<ST>(cf, c_s + 16 * I * ST, g, t);
      hold<ST32>(df, dy_s + 16 * I * ST32, g, t);
#pragma unroll 1
      for (int j0 = 0; j0 < 16 * I + 16; j0 += TW) {
        float s[NS][4], w[NS][4];
        zero(s);
        zero(w);
        mma_hr<NS, ST>(s, cf, b_s + j0 * ST, g, t);
        mma_hr<NS, ST>(w, df, x_s + j0 * ST, g, t);
#pragma unroll
        for (int jt = 0; jt < NS; ++jt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = i0 + 8 * (e >> 1);
            const int j = j0 + 8 * jt + 2 * t + (e & 1);
            const float wv =
                j <= i ? w[jt][e] * expf(CUM[i] - CUM[j]) * DT[j] : 0.f;
            rs[e >> 1] = fmaf(s[jt][e], wv, rs[e >> 1]);
            w[jt][e] = wv;
          }
        mma_fr<NS, DIM / 8, ST>(dc, w, b_s + j0 * ST, g, t);
      }
      // the carried-state term e_i dy_i S^T in its own accumulator
      float dcs[DIM / 8][4];
      zero(dcs);
      mma_hr<DIM / 8, ST32>(dcs, df, s_s, g, t);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i0 + 8 * r;
        const float e = E[i];
        float t2 = 0.f;
        float* out = dc_h + (row0 + i) * DIM + 2 * t;
#pragma unroll
        for (int n = 0; n < DIM / 8; ++n) {
          const int col = 8 * n + 2 * t;
          const float s0_ = e * dcs[n][2 * r], s1_ = e * dcs[n][2 * r + 1];
          t2 += to_f32(c_s[i * ST + col]) * s0_
                + to_f32(c_s[i * ST + col + 1]) * s1_;
          if (i < Q)
            store2(out + 8 * n, dc[n][2 * r] + s0_, dc[n][2 * r + 1] + s1_);
        }
        t2 = quad_sum(t2);
        const float rsum = quad_sum(rs[r]);
        if (t == 0) {
          T2[i] = t2;
          ROW[i] = rsum;
        }
      }
    }
  } else {
    // ---- column warps: M^T dy, w^T C, dx, db ----
    const int p = warp - 4;
    const int tiles[2] = {p, 7 - p};
    bool dbs_ready = false;
#pragma unroll 1
    for (int u = 0; u < 2; ++u) {
      const int J = tiles[u];
      if (J >= nt) continue;
      const int j0 = 16 * J + g;  // this thread's rows: j0, j0 + 8
      float dxa[DIM / 8][4], dba[DIM / 8][4];
      zero(dxa);
      zero(dba);
      float cs[2] = {0.f, 0.f};
      Held<T> bf, xf;  // B_J, x_J
      hold<ST>(bf, b_s + 16 * J * ST, g, t);
      hold<ST>(xf, x_s + 16 * J * ST, g, t);
#pragma unroll 1
      for (int i0 = 16 * J; i0 < 16 * nt; i0 += TW) {
        float m[NS][4], w[NS][4];
        zero(m);
        zero(w);
        mma_hr<NS, ST>(m, bf, c_s + i0 * ST, g, t);
        mma_hr<NS, ST32>(w, xf, dy_s + i0 * ST32, g, t);
#pragma unroll
        for (int it = 0; it < NS; ++it)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = j0 + 8 * (e >> 1);
            const int i = i0 + 8 * it + 2 * t + (e & 1);
            const float dec = i >= j ? expf(CUM[i] - CUM[j]) : 0.f;
            const float wv = w[it][e] * dec * DT[j];
            cs[e >> 1] = fmaf(m[it][e], wv, cs[e >> 1]);
            m[it][e] *= dec;
            w[it][e] = wv;
          }
        mma_fr<NS, DIM / 8, ST32>(dxa, m, dy_s + i0 * ST32, g, t);
        mma_fr<NS, DIM / 8, ST>(dba, w, c_s + i0 * ST, g, t);
      }
      // the state-update term f_j B_j G in its own accumulator
      float dxs[DIM / 8][4];
      zero(dxs);
      mma_hk<DIM / 8, ST32>(dxs, bf, g_s, g, t);
      if (!dbs_ready) {
        bar_sync(1, BWD_THREADS);
        dbs_ready = true;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = j0 + 8 * r;
        const float f = F[j], d = DT[j];
        float dot = 0.f;
        const int64_t at = (row0 + j) * DIM + 2 * t;
#pragma unroll
        for (int n = 0; n < DIM / 8; ++n) {
          const int col = 8 * n + 2 * t;
          const float v0 = fmaf(f, dxs[n][2 * r], dxa[n][2 * r]);
          const float v1 = fmaf(f, dxs[n][2 * r + 1], dxa[n][2 * r + 1]);
          dot += v0 * to_f32(x_s[j * ST + col]) + v1 * to_f32(x_s[j * ST + col + 1]);
          if (j < Q) {
            store2(dx + at + 8 * n, v0 * d, v1 * d);
            store2(db_h + at + 8 * n, dba[n][2 * r] + dbs_s[j * ST32 + col],
                   dba[n][2 * r + 1] + dbs_s[j * ST32 + col + 1]);
          }
        }
        dot = quad_sum(dot);
        const float csum = quad_sum(cs[r]);
        if (t == 0) {
          DOT[j] = dot;
          COL[j] = csum;
        }
      }
    }
    if (!dbs_ready) bar_sync(1, BWD_THREADS);
  }
  __syncthreads();

  // dcum, its suffix sums dlog and ddt, by one warp (lane L: rows 4L ..)
  if (warp == 0) {
    float dc[4], us = 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = 4 * lane + r;
      dc[r] = k < Q ? ROW[k] - COL[k] + T2[k] - U[k] : 0.f;
      us += k < Q ? U[k] : 0.f;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      us += __shfl_xor_sync(0xffffffffu, us, off);
    const float sg = SGW[0] + SGW[1] + SGW[2] + SGW[3];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (4 * lane + r == Q - 1) dc[r] += us + E[Q - 1] * sg;
    float run = 0.f, suf[4];
#pragma unroll
    for (int r = 3; r >= 0; --r) {
      run += dc[r];
      suf[r] = run;
    }
    float tot = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float dn = __shfl_down_sync(0xffffffffu, tot, off);
      if (lane + off < 32) tot += dn;
    }
    const float after = tot - run;  // the lanes above this one
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = 4 * lane + r;
      if (k < Q) {
        const float dl = suf[r] + after;
        dlog[row0 + k] = dl;
        ddt[row0 + k] = fmaf(a, dl, DOT[k]);
      }
    }
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

template <typename TU, typename TV, bool FWD>
cudaError_t launch_chunk_state(const void* u, const void* v, const float* dt,
                               const float* a, float* out, float* decay,
                               int B, int H, int S, int Q,
                               cudaStream_t stream) {
  auto kernel = ssd_chunk_state_kernel<TU, TV, FWD>;
  constexpr int smem = p1_smem<TU, TV>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B * H * (S / Q), P1_THREADS, smem, stream>>>(
      static_cast<const TU*>(u), static_cast<const TV*>(v), dt, a, out, decay,
      H, S, Q);
  return cudaGetLastError();
}

cudaError_t launch_state_pass(float* buf, const float* decay,
                              const float* init, float* final_out, int B,
                              int H, int nc, int reverse,
                              cudaStream_t stream) {
  ssd_state_pass_kernel<<<B * H * P2_BLOCKS, P2_THREADS, 0, stream>>>(
      buf, decay, init, final_out, nc, reverse);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fwd(const void* x, const float* dt, const float* a,
                       const void* b, const void* c, void* y, float* state,
                       float* states, float* decay, int B, int H, int S,
                       int Q, cudaStream_t stream) {
  cudaError_t err = launch_chunk_state<T, T, true>(b, x, dt, a, states, decay,
                                                   B, H, S, Q, stream);
  if (err != cudaSuccess) return err;
  err = launch_state_pass(states, decay, nullptr, state, B, H, S / Q, 0,
                          stream);
  if (err != cudaSuccess) return err;
  auto kernel = ssd_fwd_out_kernel<T>;
  constexpr int smem = fwd_smem<T>();
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B * H * (S / Q), FWD_THREADS, smem, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(b),
      static_cast<const T*>(c), states, static_cast<T*>(y), H, S, Q);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const float* dt, const float* a,
                       const void* b, const void* c, const float* carries,
                       const float* dy, const float* dstate, float* gbuf,
                       float* decay, float* dx, float* ddt, float* dlog,
                       float* db, float* dc, int B, int H, int S, int Q,
                       cudaStream_t stream) {
  cudaError_t err = launch_chunk_state<T, float, false>(
      c, dy, dt, a, gbuf, decay, B, H, S, Q, stream);
  if (err != cudaSuccess) return err;
  err = launch_state_pass(gbuf, decay, dstate, nullptr, B, H, S / Q, 1,
                          stream);
  if (err != cudaSuccess) return err;
  auto kernel = ssd_bwd_out_kernel<T>;
  constexpr int smem = bwd_smem<T>();
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B * H * (S / Q), BWD_THREADS, smem, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(b),
      static_cast<const T*>(c), carries, gbuf, dy, dx, ddt, dlog, db, dc, H,
      S, Q);
  return cudaGetLastError();
}

}  // namespace

// Three CUDA launches a call each.  dtype: 0 = float32, 1 = bfloat16 (x, B
// and C share it).  N and P must be 64, 1 <= Q <= 128, S % Q == 0.  The
// caller allocates the scratch: `states` (B, H, S / Q, N, P) fp32 (the
// carries when it wants them), `decay` (B, H, S / Q) fp32; backward `gbuf`
// (B, H, S / Q, N, P) and `decay`.  Returns a cudaError_t (0 = launched).
extern "C" int ssd_fwd(const void* x, const float* dt, const float* a,
                       const void* b, const void* c, void* y, float* state,
                       float* states, float* decay, int B, int H, int S,
                       int Q, int N, int P, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (Q < 1 || Q > MAX_Q || S % Q != 0 || N != DIM || P != DIM)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_fwd<float>(x, dt, a, b, c, y, state, states, decay, B, H,
                             S, Q, st);
  if (dtype == 1)
    return launch_fwd<bf16>(x, dt, a, b, c, y, state, states, decay, B, H, S,
                            Q, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int ssd_bwd(const void* x, const float* dt, const float* a,
                       const void* b, const void* c, const float* carries,
                       const float* dy, const float* dstate, float* gbuf,
                       float* decay, float* dx, float* ddt, float* dlog,
                       float* db, float* dc, int B, int H, int S, int Q,
                       int N, int P, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (Q < 1 || Q > MAX_Q || S % Q != 0 || N != DIM || P != DIM)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_bwd<float>(x, dt, a, b, c, carries, dy, dstate, gbuf, decay,
                             dx, ddt, dlog, db, dc, B, H, S, Q, st);
  if (dtype == 1)
    return launch_bwd<bf16>(x, dt, a, b, c, carries, dy, dstate, gbuf, decay,
                            dx, ddt, dlog, db, dc, B, H, S, Q, st);
  return (int)cudaErrorInvalidValue;
}
