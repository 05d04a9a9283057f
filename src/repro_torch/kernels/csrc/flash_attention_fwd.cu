// Causal flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `flash_attention_fwd` of
// src/repro/kernels/flash_attention/kernel.py (body `_fwd_kernel`, line 96;
// pallas_call at line 168).  Same function: q, k, v (BH, S, D) in fp32 or
// bf16; online softmax (m, l, acc) in fp32, the probabilities P kept in
// fp32 as the reference keeps them; keys masked past the causal diagonal
// and at or past `valid_len`; outputs o (BH, S, D) in the input dtype and
// lse = m + log(l) (BH, S) fp32.
//
// What bounds it on the H100: operations, at the tensor cores' rate.
// Causal attention does 2 * BH * S^2 * D multiply-adds against
// 4 * BH * S * D elements of traffic: at S = 512, D = 64 that is ~64
// operations per byte (fp32), above what the memory feeds.  The products
// run on the tensor cores through mma.sync:
//   * fp32 inputs: error-compensated TF32 (m16n8k8).  Each operand x is
//     split into hi = tf32(x) (cvt.rna) and lo = tf32(x - hi); the product
//     is a_lo b_hi + a_hi b_lo + a_hi b_hi, accumulated in fp32, so each
//     product carries ~2^-21 relative error (the dropped a_lo b_lo and the
//     rounding of lo), as PyTorch's memory-efficient fp32 attention does.
//     Three TF32 products: the bound is the TF32 rate (495 TFLOP/s) / 3.
//   * bf16 inputs: m16n8k16 bf16 with fp32 accumulation.  Q.K^T is exact
//     products of bf16 values.  P is fp32 and is not rounded to bf16 once:
//     it is split into a bf16 hi and lo part and P.V takes two products
//     (~2^-16 relative), so o keeps to the fp32 plain version within the
//     bf16 rounding of o itself.
//
// Design.  The TPU grid (bh, q_blocks, kv_blocks) ran its kv axis in order
// and carried (m, l, acc) in VMEM scratch.  Here one block of 4 warps owns
// one (q tile of 64 rows, bh) cell and loops over the kv tiles of 64 keys
// itself, only up to the diagonal and valid_len, so tiles above the
// diagonal are neither loaded nor computed.  Each warp owns 16 query rows:
// the score tile S (16 x 64), P, the running (m, l) and the o accumulator
// (16 x D) live in mma accumulator fragments.  The online softmax works on
// the fragments, row max through two quad shuffles (the row sum is reduced
// once, at the end), p = 2^(s log2(e) / sqrt(D) - m) by one FMA and
// ex2.approx (~2^-22 relative; the exponent is <= 0 up to the rounding of
// m).  P enters the P.V product from its registers as the A operand, with
// no round trip through shared memory (TF32: the k order within each 8-key
// step is permuted to match the accumulator layout, which the product
// allows since A and B see the same permutation).  Each kv tile's P.V
// goes to a fresh fragment and is added to the running o in fp32 round-to-
// nearest: the tensor cores truncate their sums, and that bias carried
// over all S keys put the gradients of gpt2-117m at 16 x 1024 1e-4 of a
// leaf off the plain path (delta = rowsum(dO o) cancels against dP in the
// backward), against 1e-5 this way.  K/V tiles
// are copied by 16-byte cp.async into a two-stage ring: tile t + 1 loads
// while tile t is in the MMAs.  Tiles are stored with rows padded by 16
// bytes (D + 4 floats, D + 8 bf16), so the fragment loads (scalar for TF32,
// ldmatrix for bf16) are free of bank conflicts.  Rows of a ragged last q
// tile and keys of a ragged last kv tile are masked (or zero-filled by the
// copy) here, so the wrapper makes no padded copies.  The grid runs bh
// fastest and the diagonal-most (heaviest) q tiles first.
#include <cmath>
#include <type_traits>

#include "sm90_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;        // query rows per block, 16 per warp
constexpr int BK = 64;        // keys per kv tile
constexpr int THREADS = 128;  // 4 warps
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// copies
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// fp32: error-compensated TF32 on m16n8k8
// ---------------------------------------------------------------------------

// c[j] += A B_j^T for j < NT: A the 16 rows at a_s, B_j rows 8j .. 8j + 7
// of b_s, both (rows, D) of stride ST; three TF32 products a step.
// Fragment (g = lane / 4, t = lane % 4): A rows g, g + 8, columns t, t + 4
// of each 8-step; B row 8j + g, the same columns.
template <int D, int ST, int NT>
__device__ __forceinline__ void mma_rows_tf32(float (&c)[NT][4],
                                              const float* a_s,
                                              const float* b_s, int g,
                                              int t) {
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) {
    const int k0 = ks * 8 + t;
    uint32_t ah[4], al[4];
    split_tf32(a_s[g * ST + k0], ah[0], al[0]);
    split_tf32(a_s[(g + 8) * ST + k0], ah[1], al[1]);
    split_tf32(a_s[g * ST + k0 + 4], ah[2], al[2]);
    split_tf32(a_s[(g + 8) * ST + k0 + 4], ah[3], al[3]);
    uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      split_tf32(b_s[(8 * j + g) * ST + k0], bh[j][0], bl[j][0]);
      split_tf32(b_s[(8 * j + g) * ST + k0 + 4], bh[j][1], bl[j][1]);
    }
    mma_passes<NT>(c, ah, al, bh, bl);
  }
}

// c[n] += P B for n < D / 8: P (16 x 8 NK) in accumulator fragments (p[j]
// holds rows g, g + 8 at columns 8j + 2t, 8j + 2t + 1), B rows 0 .. 8 NK - 1
// of b_s (stride ST).  Within each 8-step the k order is permuted
// (k = t -> 2t, k = t + 4 -> 2t + 1) so P enters from its registers.
template <int D, int ST, int NK>
__device__ __forceinline__ void mma_frag_tf32(float (&c)[D / 8][4],
                                              const float (&p)[NK][4],
                                              const float* b_s, int g,
                                              int t) {
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    uint32_t ah[4], al[4];
    split_tf32(p[j][0], ah[0], al[0]);
    split_tf32(p[j][2], ah[1], al[1]);
    split_tf32(p[j][1], ah[2], al[2]);
    split_tf32(p[j][3], ah[3], al[3]);
    const float* b = b_s + (8 * j + 2 * t) * ST + g;
    uint32_t bh[D / 8][2], bl[D / 8][2];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      split_tf32(b[8 * n], bh[n][0], bl[n][0]);
      split_tf32(b[ST + 8 * n], bh[n][1], bl[n][1]);
    }
    mma_passes<D / 8>(c, ah, al, bh, bl);
  }
}

// ---------------------------------------------------------------------------
// bf16: m16n8k16
// ---------------------------------------------------------------------------

// Q's A fragments of the warp's 16 rows (q_w, stride ST), one per 16-step
template <int D, int ST>
__device__ __forceinline__ void load_q_bf16(uint32_t (&qf)[D / 16][4],
                                            const bf16* q_w, int lane) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    ldsm_x4(qf[ks], q_w + (lane % 16) * ST + ks * 16 + (lane / 16) * 8);
}

// sc[j] += Q K_j^T, K_j keys 8j .. 8j + 7 of k_s; exact products
template <int D, int ST>
__device__ __forceinline__ void scores_bf16(float (&sc)[BK / 8][4],
                                            const uint32_t (&qf)[D / 16][4],
                                            const bf16* k_s, int lane) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
    for (int jj = 0; jj < BK / 16; ++jj) {
      uint32_t b[4];  // b0, b1 of key tiles 2jj and 2jj + 1
      ldsm_x4(b, k_s + (16 * jj + (lane / 16) * 8 + lane % 8) * ST + ks * 16
                     + ((lane / 8) % 2) * 8);
      mma_bf16(sc[2 * jj], qf[ks], b[0], b[1]);
      mma_bf16(sc[2 * jj + 1], qf[ks], b[2], b[3]);
    }
  }
}

// acc[n] += P V for n < D / 8; P fp32 fragments split into bf16 hi + lo
template <int D, int ST>
__device__ __forceinline__ void pv_bf16(float (&acc)[D / 8][4],
                                        const float (&p)[BK / 8][4],
                                        const bf16* v_s, int lane) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint32_t ph[4], pl[4];
    split_bf16(p[2 * kk][0], p[2 * kk][1], ph[0], pl[0]);
    split_bf16(p[2 * kk][2], p[2 * kk][3], ph[1], pl[1]);
    split_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1], ph[2], pl[2]);
    split_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3], ph[3], pl[3]);
    uint32_t b[D / 16][4];  // b0, b1 of column tiles 2nn and 2nn + 1
#pragma unroll
    for (int nn = 0; nn < D / 16; ++nn)
      ldsm_x4_t(b[nn], v_s + (16 * kk + ((lane / 8) % 2) * 8 + lane % 8) * ST
                           + 16 * nn + (lane / 16) * 8);
#pragma unroll
    for (int nn = 0; nn < D / 16; ++nn) {  // the lo pass, then the hi pass
      mma_bf16(acc[2 * nn], pl, b[nn][0], b[nn][1]);
      mma_bf16(acc[2 * nn + 1], pl, b[nn][2], b[nn][3]);
    }
#pragma unroll
    for (int nn = 0; nn < D / 16; ++nn) {
      mma_bf16(acc[2 * nn], ph, b[nn][0], b[nn][1]);
      mma_bf16(acc[2 * nn + 1], ph, b[nn][2], b[nn][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int s, int causal, int valid_len,
                 float scale_log2) {
  constexpr bool BF16 = std::is_same<T, bf16>::value;
  constexpr int ST = D + 16 / sizeof(T);  // padded row stride, elements
  constexpr int TILE = BK * ST;
  constexpr int NT = BK / 8;  // key tiles of 8 in a kv tile
  constexpr int NO = D / 8;   // column tiles of 8 in the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* ring = q_s + BQ * ST;  // stage i: K at ring + 2 i TILE, V after it

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // diagonal-most tiles first
  const int64_t head = (int64_t)bh * s * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = qt * BQ;
  const int w0 = q0 + warp * 16;  // the warp's first row
  const int row0 = w0 + g;        // this thread's rows: row0, row0 + 8

  // keys this tile's rows may see: [0, kv_end)
  int kv_end = valid_len < s ? valid_len : s;
  if (causal && q0 + BQ < kv_end) kv_end = q0 + BQ;
  const int n_kt = (kv_end + BK - 1) / BK;

  load_tile<BQ, D, ST>(q_s, q + head, q0, s);
  load_tile<BK, D, ST>(ring, k + head, 0, s);
  load_tile<BK, D, ST>(ring + TILE, v + head, 0, s);
  cp_commit();

  float m[2] = {NEG_INF, NEG_INF};  // running max, log2 units
  float l[2] = {0.f, 0.f};          // this lane's share of the row sums
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  uint32_t qf[BF16 ? D / 16 : 1][4];

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) {
      T* next = ring + ((kt + 1) & 1) * 2 * TILE;
      load_tile<BK, D, ST>(next, k + head, (kt + 1) * BK, s);
      load_tile<BK, D, ST>(next + TILE, v + head, (kt + 1) * BK, s);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // tile kt (and at kt = 0 the q tile) has landed
    const T* k_s = ring + (kt & 1) * 2 * TILE;
    const T* v_s = k_s + TILE;

    float sc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
    if constexpr (BF16) {
      if (kt == 0) load_q_bf16<D, ST>(qf, q_s + warp * 16 * ST, lane);
      scores_bf16<D, ST>(sc, qf, k_s, lane);
    } else {
      mma_rows_tf32<D, ST, NT>(sc, q_s + warp * 16 * ST, k_s, g, t);
    }

    // online softmax on the fragments: sc[j][e] is row row0 + 8 (e / 2),
    // key kv0 + 8j + 2t + (e % 2); masked scores become -inf, so their
    // p = 2^-inf = 0 (m stays finite: it starts at NEG_INF)
    const int kv0 = kt * BK;
    const bool edge = kv0 + BK > kv_end || (causal && kv0 + BK - 1 > w0);
    float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (edge) {
          const int col = kv0 + 8 * j + 2 * t + (e & 1);
          if (col >= kv_end || (causal && col > row0 + 8 * (e / 2)))
            sc[j][e] = neg_inf();
        }
        mx[e / 2] = max_nan(mx[e / 2], sc[j][e]);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = max_nan(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = max_nan(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = max_nan(m[r], mx[r] * scale_log2);
      corr[r] = ex2(m[r] - m_new);  // a difference <= 0
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(sc[j][e], scale_log2, -m[e / 2]));
        sc[j][e] = p;
        l[e / 2] += p;
      }
    }
    // this tile's P.V in a fresh accumulator, added to the running o in
    // round-to-nearest fp32: the tensor cores truncate their sums, and a
    // truncation bias carried over every kv tile grows with S
    float pv[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n) pv[n][0] = pv[n][1] = pv[n][2] = pv[n][3] = 0.f;
    if constexpr (BF16)
      pv_bf16<D, ST>(pv, sc, v_s, lane);
    else
      mma_frag_tf32<D, ST, NT>(pv, sc, v_s, g, t);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] = fmaf(acc[n][0], corr[0], pv[n][0]);
      acc[n][1] = fmaf(acc[n][1], corr[0], pv[n][1]);
      acc[n][2] = fmaf(acc[n][2], corr[1], pv[n][2]);
      acc[n][3] = fmaf(acc[n][3], corr[1], pv[n][3]);
    }
    __syncthreads();  // every warp is done with this stage before reuse
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + 8 * r;
    if (row < s) {
      const float lc = max_nan(l[r], 1e-30f);
      T* orow = o + head + (int64_t)row * D + 2 * t;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        store2(orow + 8 * n, acc[n][2 * r] / lc, acc[n][2 * r + 1] / lc);
      if (t == 0) lse[(int64_t)bh * s + row] = m[r] * LN2 + logf(lc);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int s, int causal, int valid_len,
                   cudaStream_t stream) {
  constexpr int ST = D + 16 / sizeof(T);
  const size_t smem = sizeof(T) * (size_t)(BQ + 4 * BK) * ST;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (s + BQ - 1) / BQ);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      s, causal, valid_len, LOG2E / std::sqrt((float)D));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int bh,
                                   int s, int d, int causal, int valid_len,
                                   int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (valid_len <= 0) valid_len = s;
  if (dtype == 0 && d == 64)
    return launch<float, 64>(q, k, v, o, lse, bh, s, causal, valid_len, st);
  if (dtype == 0 && d == 80)
    return launch<float, 80>(q, k, v, o, lse, bh, s, causal, valid_len, st);
  if (dtype == 0 && d == 128)
    return launch<float, 128>(q, k, v, o, lse, bh, s, causal, valid_len, st);
  if (dtype == 1 && d == 64)
    return launch<bf16, 64>(q, k, v, o, lse, bh, s, causal, valid_len, st);
  if (dtype == 1 && d == 80)
    return launch<bf16, 80>(q, k, v, o, lse, bh, s, causal, valid_len, st);
  if (dtype == 1 && d == 128)
    return launch<bf16, 128>(q, k, v, o, lse, bh, s, causal, valid_len, st);
  return (int)cudaErrorInvalidValue;
}
