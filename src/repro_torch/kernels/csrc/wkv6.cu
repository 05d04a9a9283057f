// Chunked RWKV-6 WKV recurrence for Hopper (sm_90a), forward and backward,
// plain C interface.
//
// Replaces the two TPU kernels of src/repro/kernels/rwkv6/kernel.py:
//   * wkv6_fwd_kernel <- `_wkv6_kernel` (line 31, pallas_call at 113): per
//     chunk of Q rows, y = (strictly causal pairwise-decayed r.k) v + the
//     current-token bonus (r.(u*k)) v + (r * exp(cum_in)) S, then the (D, D)
//     state S <- diag(exp(cum_last)) S + (k * exp(cum_last - cum))^T v;
//     optionally the state entering each chunk (the backward's residual);
//   * wkv6_bwd_kernel <- `_wkv6_bwd_kernel` (line 130, pallas_call at 235):
//     the reverse chunk scan carrying the (D, D) cotangent g of the
//     chunk-final state, seeded from dstate; per chunk it recomputes the
//     decay geometry from the saved inputs and the chunk's entry carry and
//     emits dr, dk, dv, d_log_w, and accumulates du.
// r, k, v are (B, H, S, D) fp32 or bf16, log_w fp32 or r's type, u (H, D)
// fp32; everything is fp32 inside.  D is 64, Q <= 64 and S % Q == 0.
//
// The pairwise weight of key j for query i (j < i) in channel d is
// exp(cum_in[i, d] - cum[j, d]), with cum the inclusive and cum_in the
// exclusive cumulative log-decay of the chunk.  The difference is taken
// before the exp, so the exponent is <= 0 however fast the decay: a
// factored exp(cum_in[i]) * exp(-cum[j]) overflows once log_w reaches
// -54.6 a token (cum past -3,000 in a chunk) and gives inf * 0 = NaN.
//
// What bounds it on the H100: operations.  Per chunk the forward does
// Q (Q - 1) / 2 * D pairwise exps and about 4 Q^2 D + 2 Q D^2 multiply-adds,
// against 4 (Q, D) tiles of input and one of output: hundreds of operations
// per byte.  This first version runs them on the fp32 CUDA cores (and the
// exps on the special-function units) out of shared memory.  The backward
// does three times the pairwise exps.
//
// Design.  The TPU carried S (and g, du) in VMEM scratch across a
// sequential chunk grid axis.  CUDA has no sequential grid axis, so one
// block owns one (b, h) and walks its chunks in order (backward: in reverse)
// with S or g in shared memory; no atomics, so the results are the same run
// to run.  Row tiles are stored with a stride of D + 1 floats so that a warp
// reading one channel of 32 rows hits 32 banks.  At B = 1 (a serving
// prefill) only H = 64 blocks run on the 132 SMs; that is left as it is.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_Q = 64;

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

// Shared floats of the forward at chunk Q: five (Q, D + 1) row tiles, the
// (Q, Q + 1) scores, the (D, D + 1) state and four vectors.
template <int D>
__host__ __device__ constexpr int fwd_smem_floats(int q) {
  return 5 * q * (D + 1) + q * (q + 1) + D * (D + 1) + MAX_Q + 2 * D;
}

// Shared floats of the backward: eight row tiles, p and the scores, the
// carry and g, and six vectors.
template <int D>
__host__ __device__ constexpr int bwd_smem_floats(int q) {
  return 8 * q * (D + 1) + 2 * q * (q + 1) + 2 * D * (D + 1) + 2 * MAX_Q
         + 3 * D;
}

// Inclusive cumulative log-decay, in place, one thread per channel:
// cum[i, d] = sum_{m <= i} log_w[m, d].
template <int D>
__device__ __forceinline__ void cumsum_channels(float* cum, int q) {
  constexpr int LD = D + 1;
  for (int d = threadIdx.x; d < D; d += THREADS) {
    float run = 0.f;
    for (int i = 0; i < q; ++i) {
      run += cum[i * LD + d];
      cum[i * LD + d] = run;
    }
  }
}

template <typename T, typename TL, int D>
__global__ void __launch_bounds__(THREADS)
wkv6_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const TL* __restrict__ log_w,
                const float* __restrict__ u, T* __restrict__ y,
                float* __restrict__ state_out, float* __restrict__ carries,
                int H, int S, int Q) {
  constexpr int LD = D + 1;
  extern __shared__ float smem[];
  const int rows = Q * LD;
  float* R = smem;          // r, then r * exp(cum_in)
  float* K = R + rows;      // k, then k * exp(cum_last - cum)
  float* V = K + rows;
  float* LW = V + rows;     // log_w
  float* CUM = LW + rows;   // inclusive cumsum (cum_in = CUM - LW)
  float* ATT = CUM + rows;  // (Q, Q + 1) pairwise scores, 0 on and above
  float* ST = ATT + Q * (Q + 1);  // (D, D + 1) state
  float* BON = ST + D * LD;       // (Q) bonus r_i . (u * k_i)
  float* AL = BON + MAX_Q;        // (D) exp(cum_last)
  float* U = AL + D;              // (D)

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int h = bh % H;
  const int nc = S / Q;
  const int64_t base = (int64_t)bh * S * D;
  for (int i = tid; i < D; i += THREADS) U[i] = u[h * D + i];
  for (int i = tid; i < D * LD; i += THREADS) ST[i] = 0.f;

  for (int c = 0; c < nc; ++c) {
    const int64_t off = base + (int64_t)c * Q * D;
    __syncthreads();  // the previous chunk is done with every tile
    for (int idx = tid; idx < Q * D; idx += THREADS) {
      const int i = idx / D, d = idx % D;
      R[i * LD + d] = to_f32(r[off + idx]);
      K[i * LD + d] = to_f32(k[off + idx]);
      V[i * LD + d] = to_f32(v[off + idx]);
      const float lw = to_f32(log_w[off + idx]);
      LW[i * LD + d] = lw;
      CUM[i * LD + d] = lw;
    }
    __syncthreads();
    cumsum_channels<D>(CUM, Q);
    for (int i = tid - D; i >= 0 && i < Q; i += THREADS) {
      float acc = 0.f;
      for (int d = 0; d < D; ++d) acc += R[i * LD + d] * U[d] * K[i * LD + d];
      BON[i] = acc;
    }
    __syncthreads();
    // att[i, j] = sum_d r[i, d] k[j, d] exp(cum_in[i, d] - cum[j, d]), j < i
    for (int idx = tid; idx < Q * Q; idx += THREADS) {
      const int i = idx / Q, j = idx % Q;
      float acc = 0.f;
      if (j < i) {
        const float* ri = R + i * LD;
        const float* li = LW + i * LD;
        const float* ci = CUM + i * LD;
        const float* kj = K + j * LD;
        const float* cj = CUM + j * LD;
#pragma unroll 8
        for (int d = 0; d < D; ++d)
          acc += ri[d] * kj[d] * __expf((ci[d] - li[d]) - cj[d]);
      }
      ATT[i * (Q + 1) + j] = acc;
    }
    if (carries != nullptr) {
      float* dst = carries + ((int64_t)bh * nc + c) * D * D;
      for (int idx = tid; idx < D * D; idx += THREADS)
        dst[idx] = ST[(idx / D) * LD + idx % D];
    }
    __syncthreads();
    // fold the decays into r and k: r * exp(cum_in), k * exp(cum_last - cum)
    for (int idx = tid; idx < Q * D; idx += THREADS) {
      const int i = idx / D, d = idx % D;
      const float cum = CUM[i * LD + d];
      R[i * LD + d] *= __expf(cum - LW[i * LD + d]);
      K[i * LD + d] *= __expf(CUM[(Q - 1) * LD + d] - cum);
    }
    for (int d = tid; d < D; d += THREADS) AL[d] = __expf(CUM[(Q - 1) * LD + d]);
    __syncthreads();
    // y[i, e] = sum_{j < i} att[i, j] v[j, e] + bon[i] v[i, e]
    //           + sum_d r_in[i, d] S[d, e]
    for (int idx = tid; idx < Q * D; idx += THREADS) {
      const int i = idx / D, e = idx % D;
      float acc = 0.f;
      for (int j = 0; j < i; ++j) acc += ATT[i * (Q + 1) + j] * V[j * LD + e];
      acc += BON[i] * V[i * LD + e];
      for (int d = 0; d < D; ++d) acc += R[i * LD + d] * ST[d * LD + e];
      y[off + idx] = from_f32<T>(acc);
    }
    __syncthreads();
    // S[d, e] <- exp(cum_last[d]) S[d, e] + sum_j k_end[j, d] v[j, e]
    for (int idx = tid; idx < D * D; idx += THREADS) {
      const int d = idx / D, e = idx % D;
      float acc = 0.f;
      for (int j = 0; j < Q; ++j) acc += K[j * LD + d] * V[j * LD + e];
      ST[d * LD + e] = AL[d] * ST[d * LD + e] + acc;
    }
  }
  __syncthreads();
  float* out = state_out + (int64_t)bh * D * D;
  for (int idx = tid; idx < D * D; idx += THREADS)
    out[idx] = ST[(idx / D) * LD + idx % D];
}

template <typename T, typename TL, int D>
__global__ void __launch_bounds__(THREADS)
wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const TL* __restrict__ log_w,
                const float* __restrict__ u, const float* __restrict__ carries,
                const float* __restrict__ dy, const float* __restrict__ dstate,
                float* __restrict__ dr, float* __restrict__ dk,
                float* __restrict__ dv, float* __restrict__ dlw,
                float* __restrict__ du_part, int H, int S, int Q) {
  constexpr int LD = D + 1;
  constexpr int PER = MAX_Q * D / THREADS;  // (i, d) cells per thread
  extern __shared__ float smem[];
  const int rows = Q * LD;
  float* R = smem;
  float* K = R + rows;
  float* V = K + rows;      // v, then the log-decay cotangent's total
  float* LW = V + rows;     // log_w, then k * dk_state
  float* CUM = LW + rows;
  float* DY = CUM + rows;
  float* EIN = DY + rows;   // exp(cum_in)
  float* KF = EIN + rows;   // k * exp(cum_last - cum), then dcum_in
  float* P = KF + rows;     // (Q, Q + 1): p[i, j] = dy_i . v_j
  float* ATT = P + Q * (Q + 1);
  float* ST = ATT + Q * (Q + 1);  // (D, D + 1) carry entering the chunk
  float* G = ST + D * LD;         // (D, D + 1) cotangent of the chunk's end
  float* BON = G + D * LD;        // (Q)
  float* DP = BON + MAX_Q;        // (Q) p[i, i]
  float* AL = DP + MAX_Q;         // (D) exp(cum_last)
  float* U = AL + D;              // (D)
  float* DU = U + D;              // (D) du, summed over the chunks

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int h = bh % H;
  const int nc = S / Q;
  const int64_t base = (int64_t)bh * S * D;
  for (int i = tid; i < D; i += THREADS) {
    U[i] = u[h * D + i];
    DU[i] = 0.f;
  }
  for (int idx = tid; idx < D * D; idx += THREADS)
    G[(idx / D) * LD + idx % D] = dstate[(int64_t)bh * D * D + idx];

  for (int c = nc - 1; c >= 0; --c) {
    const int64_t off = base + (int64_t)c * Q * D;
    __syncthreads();
    for (int idx = tid; idx < Q * D; idx += THREADS) {
      const int i = idx / D, d = idx % D;
      R[i * LD + d] = to_f32(r[off + idx]);
      K[i * LD + d] = to_f32(k[off + idx]);
      V[i * LD + d] = to_f32(v[off + idx]);
      const float lw = to_f32(log_w[off + idx]);
      LW[i * LD + d] = lw;
      CUM[i * LD + d] = lw;
      DY[i * LD + d] = dy[off + idx];
    }
    const float* carry = carries + ((int64_t)bh * nc + c) * D * D;
    for (int idx = tid; idx < D * D; idx += THREADS)
      ST[(idx / D) * LD + idx % D] = carry[idx];
    __syncthreads();
    cumsum_channels<D>(CUM, Q);
    for (int i = tid - D; i >= 0 && i < Q; i += THREADS) {
      float bon = 0.f, dp = 0.f;
      for (int d = 0; d < D; ++d) {
        bon += R[i * LD + d] * U[d] * K[i * LD + d];
        dp += DY[i * LD + d] * V[i * LD + d];
      }
      BON[i] = bon;
      DP[i] = dp;
    }
    __syncthreads();
    for (int idx = tid; idx < Q * D; idx += THREADS) {
      const int i = idx / D, d = idx % D;
      const float cum = CUM[i * LD + d];
      EIN[i * LD + d] = __expf(cum - LW[i * LD + d]);
      KF[i * LD + d] = K[i * LD + d] * __expf(CUM[(Q - 1) * LD + d] - cum);
    }
    for (int d = tid; d < D; d += THREADS) AL[d] = __expf(CUM[(Q - 1) * LD + d]);
    for (int idx = tid; idx < Q * Q; idx += THREADS) {
      const int i = idx / Q, j = idx % Q;
      const float* yi = DY + i * LD;
      const float* vj = V + j * LD;
      float p = 0.f;
      for (int e = 0; e < D; ++e) p += yi[e] * vj[e];
      P[i * (Q + 1) + j] = p;
      float att = 0.f;
      if (j < i) {
        const float* ri = R + i * LD;
        const float* li = LW + i * LD;
        const float* ci = CUM + i * LD;
        const float* kj = K + j * LD;
        const float* cj = CUM + j * LD;
#pragma unroll 8
        for (int d = 0; d < D; ++d)
          att += ri[d] * kj[d] * __expf((ci[d] - li[d]) - cj[d]);
      }
      ATT[i * (Q + 1) + j] = att;
    }
    __syncthreads();
    // per (i, d): dr, dk, dv out; the log-decay cotangent's terms held
    float total[PER], dcin[PER], kds[PER];
#pragma unroll
    for (int n = 0; n < PER; ++n) {
      const int idx = tid + n * THREADS;
      if (idx >= Q * D) break;
      const int i = idx / D, d = idx % D;
      const float cum_i = CUM[i * LD + d];
      const float cin_i = cum_i - LW[i * LD + d];
      float dr_intra = 0.f, dk_intra = 0.f;
      for (int j = 0; j < i; ++j)
        dr_intra += __expf(cin_i - CUM[j * LD + d]) * K[j * LD + d]
                    * P[i * (Q + 1) + j];
      for (int m = i + 1; m < Q; ++m)
        dk_intra += __expf((CUM[m * LD + d] - LW[m * LD + d]) - cum_i)
                    * R[m * LD + d] * P[m * (Q + 1) + i];
      float ys = 0.f, vg = 0.f, dvv = BON[i] * DY[i * LD + d];
      for (int e = 0; e < D; ++e) {
        ys += DY[i * LD + e] * ST[d * LD + e];
        vg += V[i * LD + e] * G[d * LD + e];
        dvv += KF[i * LD + e] * G[e * LD + d];
      }
      for (int m = i + 1; m < Q; ++m)
        dvv += ATT[m * (Q + 1) + i] * DY[m * LD + d];
      const float dr_state = EIN[i * LD + d] * ys;
      const float dk_state = __expf(CUM[(Q - 1) * LD + d] - cum_i) * vg;
      const float ri = R[i * LD + d], ki = K[i * LD + d];
      dr[off + idx] = dr_intra + dr_state + U[d] * ki * DP[i];
      dk[off + idx] = dk_intra + dk_state + U[d] * ri * DP[i];
      dv[off + idx] = dvv;
      dcin[n] = ri * (dr_intra + dr_state);
      total[n] = dcin[n] - ki * (dk_intra + dk_state);
      kds[n] = ki * dk_state;
    }
    __syncthreads();
#pragma unroll
    for (int n = 0; n < PER; ++n) {
      const int idx = tid + n * THREADS;
      if (idx >= Q * D) break;
      const int cell = (idx / D) * LD + idx % D;
      V[cell] = total[n];
      KF[cell] = dcin[n];
      LW[cell] = kds[n];
    }
    __syncthreads();
    // per channel: the last row's extra terms, the reverse cumsum, du
    for (int d = tid; d < D; d += THREADS) {
      float last = 0.f, sg = 0.f, du = 0.f;
      for (int j = 0; j < Q; ++j) {
        last += LW[j * LD + d];
        du += R[j * LD + d] * K[j * LD + d] * DP[j];
      }
      for (int e = 0; e < D; ++e) sg += ST[d * LD + e] * G[d * LD + e];
      last += AL[d] * sg;
      DU[d] += du;
      float run = last;
      for (int i = Q - 1; i >= 0; --i) {
        run += V[i * LD + d];
        dlw[off + (int64_t)i * D + d] = run - KF[i * LD + d];
      }
    }
    __syncthreads();
    // g <- diag(exp(cum_last)) g + (r * exp(cum_in))^T dy
    for (int idx = tid; idx < D * D; idx += THREADS) {
      const int d = idx / D, e = idx % D;
      float acc = 0.f;
      for (int i = 0; i < Q; ++i)
        acc += R[i * LD + d] * EIN[i * LD + d] * DY[i * LD + e];
      G[d * LD + e] = AL[d] * G[d * LD + e] + acc;
    }
  }
  __syncthreads();
  for (int d = tid; d < D; d += THREADS)
    du_part[(int64_t)bh * D + d] = DU[d];
}

template <typename T, typename TL, int D>
cudaError_t launch_fwd(const void* r, const void* k, const void* v,
                       const void* log_w, const float* u, void* y,
                       float* state, float* carries, int B, int H, int S,
                       int Q, cudaStream_t stream) {
  auto kernel = wkv6_fwd_kernel<T, TL, D>;
  const size_t max_bytes = sizeof(float) * fwd_smem_floats<D>(MAX_Q);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)max_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<B * H, THREADS, sizeof(float) * fwd_smem_floats<D>(Q), stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const TL*>(log_w), u,
      static_cast<T*>(y), state, carries, H, S, Q);
  return cudaGetLastError();
}

template <typename T, typename TL, int D>
cudaError_t launch_bwd(const void* r, const void* k, const void* v,
                       const void* log_w, const float* u,
                       const float* carries, const float* dy,
                       const float* dstate, float* dr, float* dk, float* dv,
                       float* dlw, float* du, int B, int H, int S, int Q,
                       cudaStream_t stream) {
  auto kernel = wkv6_bwd_kernel<T, TL, D>;
  const size_t max_bytes = sizeof(float) * bwd_smem_floats<D>(MAX_Q);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)max_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<B * H, THREADS, sizeof(float) * bwd_smem_floats<D>(Q), stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const TL*>(log_w), u, carries, dy,
      dstate, dr, dk, dv, dlw, du, H, S, Q);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (r, k, v share one; log_w is
// float32 or r's).  Returns a cudaError_t (0 = launched).
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v,
                        const void* log_w, const float* u, void* y,
                        float* state, float* carries, int B, int H, int S,
                        int Q, int dtype, int lw_dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (Q < 1 || Q > MAX_Q || S % Q != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && lw_dtype == 0)
    return launch_fwd<float, float, 64>(r, k, v, log_w, u, y, state, carries,
                                        B, H, S, Q, st);
  if (dtype == 1 && lw_dtype == 0)
    return launch_fwd<__nv_bfloat16, float, 64>(r, k, v, log_w, u, y, state,
                                                carries, B, H, S, Q, st);
  if (dtype == 1 && lw_dtype == 1)
    return launch_fwd<__nv_bfloat16, __nv_bfloat16, 64>(
        r, k, v, log_w, u, y, state, carries, B, H, S, Q, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int wkv6_bwd(const void* r, const void* k, const void* v,
                        const void* log_w, const float* u,
                        const float* carries, const float* dy,
                        const float* dstate, float* dr, float* dk, float* dv,
                        float* dlw, float* du, int B, int H, int S, int Q,
                        int dtype, int lw_dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (Q < 1 || Q > MAX_Q || S % Q != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && lw_dtype == 0)
    return launch_bwd<float, float, 64>(r, k, v, log_w, u, carries, dy,
                                        dstate, dr, dk, dv, dlw, du, B, H, S,
                                        Q, st);
  if (dtype == 1 && lw_dtype == 0)
    return launch_bwd<__nv_bfloat16, float, 64>(r, k, v, log_w, u, carries,
                                                dy, dstate, dr, dk, dv, dlw,
                                                du, B, H, S, Q, st);
  if (dtype == 1 && lw_dtype == 1)
    return launch_bwd<__nv_bfloat16, __nv_bfloat16, 64>(
        r, k, v, log_w, u, carries, dy, dstate, dr, dk, dv, dlw, du, B, H, S,
        Q, st);
  return (int)cudaErrorInvalidValue;
}
