// Mamba-2 chunked SSD scan for Hopper (sm_90a), forward and backward, plain
// C interface.
//
// Replaces the two TPU kernels of src/repro/kernels/ssd/kernel.py:
//   * ssd_fwd_kernel <- `_ssd_kernel` (line 35, pallas_call at 116): per
//     chunk of Q rows, y = (C B^T o decay) (x dt) + exp(cum) (C S), then the
//     (N, P) state S <- exp(cum_Q) S + sum_j exp(cum_Q - cum_j) B_j^T (x dt)_j;
//     optionally the state entering each chunk (the backward's residual);
//   * ssd_bwd_kernel <- `_ssd_bwd_kernel` (line 138, pallas_call at 234):
//     the reverse chunk scan carrying the (N, P) cotangent g of the
//     chunk-final state, seeded from dstate; per chunk it recomputes the
//     decay geometry from the saved inputs and the chunk's entry carry and
//     emits dx, ddt, dlog and the per-head db_h, dc_h.
// x is (B, H, S, P) fp32 or bf16, B and C (B, S, N) in x's type and shared
// by the heads, dt (B, H, S) fp32, a (H,) fp32; everything is fp32 inside.
// N = P = 64, Q <= 128 and S % Q == 0.
//
// cum is the inclusive cumulative sum of dt * a over the chunk.  Every
// exponent is taken of a difference, cum_i - cum_j (j <= i), cum_i or
// cum_Q - cum_j, all <= 0: a factored exp(cum_i) * exp(-cum_j) overflows
// once cum passes -88 and gives inf * 0 = NaN.
//
// What bounds it on the H100: operations.  Per chunk the forward does
// Q (Q + 1) / 2 (N + P) + 2 Q N P multiply-adds against four (Q, 64) tiles
// of input and output; the backward about three times that.  This first
// version runs them on the fp32 CUDA cores out of shared memory.
//
// Design.  The TPU carried the state (and the cotangent) in VMEM scratch
// across a sequential chunk grid axis.  CUDA has no sequential grid axis,
// so one block owns one (b, h) and walks its chunks in order (backward: in
// reverse) with the state or g in shared memory; no atomics, so results are
// the same run to run.  Row tiles are stored with a stride of 65 floats so
// that a warp reading one column of 32 rows hits 32 banks.  At B = 1 (a
// serving prefill) only H = 80 blocks run on the 132 SMs; that is left as
// it is.
//
// Shared memory at Q = 128.  Forward: x dt, B and C tiles (3 x 33 KB), the
// (Q, Q + 1) score tile (66 KB) and the state (17 KB): 184 KB.  The
// backward keeps one (Q, Q + 1) tile, not the two the TPU kernel held
// (scores and w): it holds first the entry carry, then M = scores o decay
// (for dx, and, through y_intra and dxdt_intra, the row and column sums of
// t = M o (dy x_dt^T)), then w = decay o (dy x_dt^T) (for dB and dC).
// With x dt, B, C, dy and g it comes to 218 KB of the 227 KB a block may
// opt into.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_Q = 128;
constexpr int NRED = 10;  // per-row partial sums of the backward, 2 each

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Inclusive scan of in[k] * scale over k < q by one warp (q <= MAX_Q):
// out[k] = sum_{m <= k} in[m] * scale, or with `reverse` the suffix sums
// out[k] = sum_{m >= k} in[m] * scale.  Each lane sums MAX_Q / 32
// consecutive terms; a shuffle scan joins the lanes.
__device__ __forceinline__ void warp_scan(const float* in, float scale,
                                          float* out, int q, bool reverse) {
  constexpr int R = MAX_Q / 32;
  const int lane = threadIdx.x & 31;
  float vals[R];
  float run = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int k = lane * R + r;
    const int idx = reverse ? q - 1 - k : k;
    run += k < q ? in[idx] * scale : 0.f;
    vals[r] = run;
  }
  float tot = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, tot, off);
    if (lane >= off) tot += t;
  }
  const float before = tot - run;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int k = lane * R + r;
    if (k < q) out[reverse ? q - 1 - k : k] = vals[r] + before;
  }
}

template <int N, int P>
__host__ __device__ constexpr int fwd_smem_floats(int q) {
  return q * (P + 1) + 2 * q * (N + 1) + q * (q + 1) + N * (P + 1)
         + 3 * MAX_Q;
}

template <int N, int P>
__host__ __device__ constexpr int bwd_tile_floats(int q) {
  return q * (q + 1) > N * (P + 1) ? q * (q + 1) : N * (P + 1);
}

template <int N, int P>
__host__ __device__ constexpr int bwd_smem_floats(int q) {
  return 2 * q * (P + 1) + 2 * q * (N + 1) + N * (P + 1)
         + bwd_tile_floats<N, P>(q) + 5 * MAX_Q + NRED * MAX_Q + WARPS;
}

// Stage one chunk of rows s0 .. s0 + q: x * dt into XDT, B and C.
template <typename T, int N, int P>
__device__ __forceinline__ void load_chunk(const T* x, const float* dt,
                                           const T* b, const T* c, int s0,
                                           int q, float* XDT, float* BS,
                                           float* CS) {
  constexpr int LP = P + 1, LN = N + 1;
  for (int idx = threadIdx.x; idx < q * P; idx += THREADS) {
    const int i = idx / P, p = idx % P;
    XDT[i * LP + p] = to_f32(x[(int64_t)(s0 + i) * P + p]) * dt[s0 + i];
  }
  for (int idx = threadIdx.x; idx < q * N; idx += THREADS) {
    const int i = idx / N, n = idx % N;
    BS[i * LN + n] = to_f32(b[(int64_t)(s0 + i) * N + n]);
    CS[i * LN + n] = to_f32(c[(int64_t)(s0 + i) * N + n]);
  }
}

// M[i][j] = (C_i . B_j) exp(cum_i - cum_j) for j <= i, else 0.
template <int N>
__device__ __forceinline__ void build_scores(const float* CS, const float* BS,
                                             const float* CUM, float* M,
                                             int q) {
  constexpr int LN = N + 1;
  for (int idx = threadIdx.x; idx < q * q; idx += THREADS) {
    const int i = idx / q, j = idx % q;
    float acc = 0.f;
    if (j <= i) {
      const float* ci = CS + i * LN;
      const float* bj = BS + j * LN;
#pragma unroll 8
      for (int n = 0; n < N; ++n) acc += ci[n] * bj[n];
      acc *= __expf(CUM[i] - CUM[j]);
    }
    M[i * (q + 1) + j] = acc;
  }
}

template <typename T, int N, int P>
__global__ void __launch_bounds__(THREADS)
ssd_fwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a_coef, const T* __restrict__ b_in,
               const T* __restrict__ c_in, T* __restrict__ y,
               float* __restrict__ state_out, float* __restrict__ carries,
               int H, int S, int Q) {
  static_assert(N % 32 == 0 && P % 32 == 0, "N, P multiples of 32");
  constexpr int LP = P + 1, LN = N + 1;
  extern __shared__ float smem[];
  float* XDT = smem;               // (Q, P + 1) x * dt
  float* BS = XDT + Q * LP;        // (Q, N + 1)
  float* CS = BS + Q * LN;         // (Q, N + 1)
  float* M = CS + Q * LN;          // (Q, Q + 1) scores o decay
  float* ST = M + Q * (Q + 1);     // (N, P + 1) state
  float* CUM = ST + N * LP;        // (Q) inclusive cumsum of dt * a
  float* E = CUM + MAX_Q;          // (Q) exp(cum)
  float* F = E + MAX_Q;            // (Q) exp(cum_last - cum)

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int h = bh % H, b = bh / H;
  const int nc = S / Q;
  const float a = a_coef[h];
  const T* xb = x + (int64_t)bh * S * P;
  const float* dtb = dt + (int64_t)bh * S;
  const T* bb = b_in + (int64_t)b * S * N;
  const T* cb = c_in + (int64_t)b * S * N;
  T* yb = y + (int64_t)bh * S * P;
  for (int i = tid; i < N * LP; i += THREADS) ST[i] = 0.f;

  for (int c = 0; c < nc; ++c) {
    const int s0 = c * Q;
    __syncthreads();  // the previous chunk is done with every tile
    load_chunk<T, N, P>(xb, dtb, bb, cb, s0, Q, XDT, BS, CS);
    if (tid < 32) warp_scan(dtb + s0, a, CUM, Q, false);
    if (carries != nullptr) {
      float* dst = carries + ((int64_t)bh * nc + c) * N * P;
      for (int idx = tid; idx < N * P; idx += THREADS)
        dst[idx] = ST[(idx / P) * LP + idx % P];
    }
    __syncthreads();
    for (int i = tid; i < Q; i += THREADS) {
      E[i] = __expf(CUM[i]);
      F[i] = __expf(CUM[Q - 1] - CUM[i]);
    }
    build_scores<N>(CS, BS, CUM, M, Q);
    __syncthreads();
    // y[i, p] = sum_{j <= i} M[i, j] xdt[j, p] + exp(cum_i) sum_n C[i, n] S[n, p]
    for (int idx = tid; idx < Q * P; idx += THREADS) {
      const int i = idx / P, p = idx % P;
      float acc = 0.f, inter = 0.f;
      for (int j = 0; j <= i; ++j) acc += M[i * (Q + 1) + j] * XDT[j * LP + p];
#pragma unroll 8
      for (int n = 0; n < N; ++n) inter += CS[i * LN + n] * ST[n * LP + p];
      yb[(int64_t)(s0 + i) * P + p] = from_f32<T>(acc + E[i] * inter);
    }
    __syncthreads();
    // S[n, p] <- exp(cum_last) S[n, p] + sum_j exp(cum_last - cum_j) B[j, n] xdt[j, p]
    const float alpha = E[Q - 1];
    for (int idx = tid; idx < N * P; idx += THREADS) {
      const int n = idx / P, p = idx % P;
      float acc = 0.f;
      for (int j = 0; j < Q; ++j) acc += F[j] * BS[j * LN + n] * XDT[j * LP + p];
      ST[n * LP + p] = alpha * ST[n * LP + p] + acc;
    }
  }
  __syncthreads();
  float* out = state_out + (int64_t)bh * N * P;
  for (int idx = tid; idx < N * P; idx += THREADS)
    out[idx] = ST[(idx / P) * LP + idx % P];
}

template <typename T, int N, int P>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a_coef, const T* __restrict__ b_in,
               const T* __restrict__ c_in, const float* __restrict__ carries,
               const float* __restrict__ dy, const float* __restrict__ dstate,
               float* __restrict__ dx, float* __restrict__ ddt,
               float* __restrict__ dlog, float* __restrict__ db_h,
               float* __restrict__ dc_h, int H, int S, int Q) {
  static_assert(N % 32 == 0 && P % 32 == 0, "N, P multiples of 32");
  constexpr int LP = P + 1, LN = N + 1;
  extern __shared__ float smem[];
  float* XDT = smem;               // (Q, P + 1) x * dt
  float* DY = XDT + Q * LP;        // (Q, P + 1)
  float* BS = DY + Q * LP;         // (Q, N + 1)
  float* CS = BS + Q * LN;         // (Q, N + 1)
  float* G = CS + Q * LN;          // (N, P + 1) cotangent of the chunk's end
  float* TILE = G + N * LP;        // carry (N, P + 1), then M, then w
  float* CUM = TILE + bwd_tile_floats<N, P>(Q);
  float* E = CUM + MAX_Q;          // exp(cum)
  float* F = E + MAX_Q;            // exp(cum_last - cum)
  float* DCUM = F + MAX_Q;         // cotangent of cum
  float* DLOG = DCUM + MAX_Q;      // its suffix sums
  // per row, two halves each: t2, u, sum_p dxdt x, column and row sums of t
  float* RED = DLOG + MAX_Q;
  float* WSUM = RED + NRED * MAX_Q;  // per-warp partials of <S_prev, G>

  const int tid = threadIdx.x, lane = tid & 31, warp = tid / 32;
  const int bh = blockIdx.x;
  const int h = bh % H, b = bh / H;
  const int nc = S / Q;
  const int TQ = Q + 1;
  const float a = a_coef[h];
  const T* xb = x + (int64_t)bh * S * P;
  const float* dtb = dt + (int64_t)bh * S;
  const T* bb = b_in + (int64_t)b * S * N;
  const T* cb = c_in + (int64_t)b * S * N;
  const float* dyb = dy + (int64_t)bh * S * P;
  float* dxb = dx + (int64_t)bh * S * P;
  float* dbb = db_h + (int64_t)bh * S * N;
  float* dcb = dc_h + (int64_t)bh * S * N;
  for (int idx = tid; idx < N * P; idx += THREADS)
    G[(idx / P) * LP + idx % P] = dstate[(int64_t)bh * N * P + idx];

  for (int c = nc - 1; c >= 0; --c) {
    const int s0 = c * Q;
    __syncthreads();
    load_chunk<T, N, P>(xb, dtb, bb, cb, s0, Q, XDT, BS, CS);
    for (int idx = tid; idx < Q * P; idx += THREADS)
      DY[(idx / P) * LP + idx % P] = dyb[(int64_t)s0 * P + idx];
    const float* carry = carries + ((int64_t)bh * nc + c) * N * P;
    for (int idx = tid; idx < N * P; idx += THREADS)
      TILE[(idx / P) * LP + idx % P] = carry[idx];
    if (tid < 32) warp_scan(dtb + s0, a, CUM, Q, false);
    __syncthreads();
    for (int i = tid; i < Q; i += THREADS) {
      E[i] = __expf(CUM[i]);
      F[i] = __expf(CUM[Q - 1] - CUM[i]);
    }
    __syncthreads();
    // 1. the carried-state terms: dc_state[i, n] = e_i sum_p dy[i, p] S[n, p]
    //    and db_state[j, n] = f_j sum_p xdt[j, p] g[n, p], written out now
    //    and completed in step 5; t2_i = C_i . dc_state_i, u_j = B_j .
    //    db_state_j; and <S_prev, g>.  A warp covers 32 n of one row.
    for (int idx = tid; idx < Q * N; idx += THREADS) {
      const int i = idx / N, n = idx % N;
      float ys = 0.f, xg = 0.f;
#pragma unroll 8
      for (int p = 0; p < P; ++p) {
        ys += DY[i * LP + p] * TILE[n * LP + p];
        xg += XDT[i * LP + p] * G[n * LP + p];
      }
      const float dcs = E[i] * ys, dbs = F[i] * xg;
      const int64_t o = (int64_t)(s0 + i) * N + n;
      dcb[o] = dcs;
      dbb[o] = dbs;
      const float t2 = warp_sum(CS[i * LN + n] * dcs);
      const float u = warp_sum(BS[i * LN + n] * dbs);
      if (lane == 0) {
        RED[i * NRED + 0 + n / 32] = t2;
        RED[i * NRED + 2 + n / 32] = u;
      }
    }
    float sg = 0.f;
    for (int idx = tid; idx < N * P; idx += THREADS) {
      const int cell = (idx / P) * LP + idx % P;
      sg += TILE[cell] * G[cell];
    }
    sg = warp_sum(sg);
    if (lane == 0) WSUM[warp] = sg;
    __syncthreads();
    // 2. TILE <- M = scores o decay
    build_scores<N>(CS, BS, CUM, TILE, Q);
    __syncthreads();
    // 3. per (r, p): dxdt_intra[r, p] = sum_{i >= r} M[i, r] dy[i, p] (column
    //    r of M) and y_intra[r, p] = sum_{j <= r} M[r, j] xdt[j, p] (row r);
    //    dxdt = dxdt_intra + f_r (B_r g)[p]; dx = dxdt dt_r.  The row sums
    //    of t = M o (dy xdt^T) are sum_p dy y_intra, its column sums
    //    sum_p xdt dxdt_intra.
    for (int idx = tid; idx < Q * P; idx += THREADS) {
      const int r = idx / P, p = idx % P;
      float dxi = 0.f, yi = 0.f, bg = 0.f;
      for (int i = r; i < Q; ++i) dxi += TILE[i * TQ + r] * DY[i * LP + p];
      for (int j = 0; j <= r; ++j) yi += TILE[r * TQ + j] * XDT[j * LP + p];
#pragma unroll 8
      for (int n = 0; n < N; ++n) bg += BS[r * LN + n] * G[n * LP + p];
      const float dxdt = dxi + F[r] * bg;
      const int64_t o = (int64_t)(s0 + r) * P + p;
      dxb[o] = dxdt * dtb[s0 + r];
      const float dot = warp_sum(dxdt * to_f32(xb[o]));
      const float col = warp_sum(XDT[r * LP + p] * dxi);
      const float row = warp_sum(DY[r * LP + p] * yi);
      if (lane == 0) {
        RED[r * NRED + 4 + p / 32] = dot;
        RED[r * NRED + 6 + p / 32] = col;
        RED[r * NRED + 8 + p / 32] = row;
      }
    }
    __syncthreads();
    // 4. TILE <- w[i, j] = exp(cum_i - cum_j) (dy_i . xdt_j), j <= i
    for (int idx = tid; idx < Q * Q; idx += THREADS) {
      const int i = idx / Q, j = idx % Q;
      float acc = 0.f;
      if (j <= i) {
        const float* yi = DY + i * LP;
        const float* xj = XDT + j * LP;
#pragma unroll 8
        for (int p = 0; p < P; ++p) acc += yi[p] * xj[p];
        acc *= __expf(CUM[i] - CUM[j]);
      }
      TILE[i * TQ + j] = acc;
    }
    __syncthreads();
    // 5. dc[r, n] += sum_{j <= r} w[r, j] B[j, n]; db[r, n] += sum_{i >= r}
    //    w[i, r] C[i, n] (each cell by the thread that wrote it in step 1)
    for (int idx = tid; idx < Q * N; idx += THREADS) {
      const int r = idx / N, n = idx % N;
      float dci = 0.f, dbi = 0.f;
      for (int j = 0; j <= r; ++j) dci += TILE[r * TQ + j] * BS[j * LN + n];
      for (int i = r; i < Q; ++i) dbi += TILE[i * TQ + r] * CS[i * LN + n];
      const int64_t o = (int64_t)(s0 + r) * N + n;
      dcb[o] += dci;
      dbb[o] += dbi;
    }
    // 6. dcum = rowsum(t) - colsum(t) + t2 - u, the last row also
    //    sum_j u_j + alpha <S_prev, g>; dlog = suffix sums of dcum
    for (int r = tid; r < Q; r += THREADS) {
      const float* row = RED + r * NRED;
      DCUM[r] = (row[8] + row[9]) - (row[6] + row[7]) + (row[0] + row[1])
                - (row[2] + row[3]);
    }
    __syncthreads();
    if (tid == 0) {
      float last = 0.f, sgt = 0.f;
      for (int j = 0; j < Q; ++j) last += RED[j * NRED + 2] + RED[j * NRED + 3];
      for (int w = 0; w < WARPS; ++w) sgt += WSUM[w];
      DCUM[Q - 1] += last + E[Q - 1] * sgt;
    }
    __syncthreads();
    if (tid < 32) warp_scan(DCUM, 1.f, DLOG, Q, true);
    __syncthreads();
    for (int r = tid; r < Q; r += THREADS) {
      const int64_t o = (int64_t)bh * S + s0 + r;
      ddt[o] = a * DLOG[r] + (RED[r * NRED + 4] + RED[r * NRED + 5]);
      dlog[o] = DLOG[r];
    }
    // 7. g <- exp(cum_last) g + sum_i exp(cum_i) C_i^T dy_i
    const float alpha = E[Q - 1];
    for (int idx = tid; idx < N * P; idx += THREADS) {
      const int n = idx / P, p = idx % P;
      float acc = 0.f;
      for (int i = 0; i < Q; ++i) acc += E[i] * CS[i * LN + n] * DY[i * LP + p];
      G[n * LP + p] = alpha * G[n * LP + p] + acc;
    }
  }
}

template <typename T, int N, int P>
cudaError_t launch_fwd(const void* x, const float* dt, const float* a,
                       const void* b, const void* c, void* y, float* state,
                       float* carries, int B, int H, int S, int Q,
                       cudaStream_t stream) {
  auto kernel = ssd_fwd_kernel<T, N, P>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(sizeof(float) * fwd_smem_floats<N, P>(MAX_Q)));
  if (err != cudaSuccess) return err;
  kernel<<<B * H, THREADS, sizeof(float) * fwd_smem_floats<N, P>(Q),
           stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<T*>(y), state, carries, H, S, Q);
  return cudaGetLastError();
}

template <typename T, int N, int P>
cudaError_t launch_bwd(const void* x, const float* dt, const float* a,
                       const void* b, const void* c, const float* carries,
                       const float* dy, const float* dstate, float* dx,
                       float* ddt, float* dlog, float* db, float* dc, int B,
                       int H, int S, int Q, cudaStream_t stream) {
  auto kernel = ssd_bwd_kernel<T, N, P>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(sizeof(float) * bwd_smem_floats<N, P>(MAX_Q)));
  if (err != cudaSuccess) return err;
  kernel<<<B * H, THREADS, sizeof(float) * bwd_smem_floats<N, P>(Q),
           stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(b),
      static_cast<const T*>(c), carries, dy, dstate, dx, ddt, dlog, db, dc,
      H, S, Q);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B and C share it).  N and P must be
// 64.  Returns a cudaError_t (0 = launched).
extern "C" int ssd_fwd(const void* x, const float* dt, const float* a,
                       const void* b, const void* c, void* y, float* state,
                       float* carries, int B, int H, int S, int Q, int N,
                       int P, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (Q < 1 || Q > MAX_Q || S % Q != 0 || N != 64 || P != 64)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_fwd<float, 64, 64>(x, dt, a, b, c, y, state, carries, B, H,
                                     S, Q, st);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16, 64, 64>(x, dt, a, b, c, y, state,
                                             carries, B, H, S, Q, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int ssd_bwd(const void* x, const float* dt, const float* a,
                       const void* b, const void* c, const float* carries,
                       const float* dy, const float* dstate, float* dx,
                       float* ddt, float* dlog, float* db, float* dc, int B,
                       int H, int S, int Q, int N, int P, int dtype,
                       void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (Q < 1 || Q > MAX_Q || S % Q != 0 || N != 64 || P != 64)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_bwd<float, 64, 64>(x, dt, a, b, c, carries, dy, dstate, dx,
                                     ddt, dlog, db, dc, B, H, S, Q, st);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16, 64, 64>(x, dt, a, b, c, carries, dy,
                                             dstate, dx, ddt, dlog, db, dc, B,
                                             H, S, Q, st);
  return (int)cudaErrorInvalidValue;
}
