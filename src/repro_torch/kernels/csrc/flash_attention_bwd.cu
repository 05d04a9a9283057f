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
// P = exp(S * scale - lse) is rebuilt from the forward's fp32 lse (BH, S),
// with dP = dO V^T.  q, k, v, o, dO are (BH, S, D) in fp32 or bf16, upcast
// to fp32 before every product; dq, dk, dv come out in the input dtype.
// Keys at or past `valid_len`, keys past the causal diagonal and query rows
// at or past S contribute nothing, so a ragged S needs no padded copy.
//
// What bounds it on the H100: operations.  The dQ kernel does three and the
// dK/dV kernel four products of 2 * D multiply-adds per (query, key) pair
// below the diagonal (five distinct products, S recomputed in both), against
// a few (BH, S, D) tensors of traffic: at S = 1024, D = 64 that is hundreds
// of operations per byte.  Like the forward, this first version runs its
// products on the fp32 CUDA cores (67 TFLOP/s peak) out of shared memory,
// about one shared load per multiply-add; wgmma on bf16 tiles is later work.
// The delta kernel alone is bytes-bound (two reads of (BH, S, D)).
//
// Design.  The TPU carried dq in VMEM scratch across a sequential kv grid
// axis, and dk/dv across a sequential q axis.  Here there is no sequential
// grid: one block owns one (q tile, bh) cell of dQ and loops over the kv
// tiles itself, and one block owns one (kv tile, bh) cell of dK/dV and
// loops over the q tiles itself.  No atomics, so results are the same run
// to run.  Tiles above the diagonal are neither loaded nor computed (the
// TPU clamped its index maps instead).  256 threads form 64 quads: in the
// dQ kernel a quad owns one query row (a lane scores 16 of the tile's 64
// keys and owns D/4 dq columns); in the dK/dV kernel a quad owns one key
// row (a lane scores 16 of the tile's 64 queries and owns D/4 columns of
// dk and dv).  The score rows pass from the score phase to the
// accumulation phase through shared memory, read back only by their quad.
// Tiles are stored with a stride of D + 1 floats so the rows a warp reads
// fall in distinct banks.  The heaviest cells launch first.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 4 threads per tile row

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

// Copy rows [row0, row0 + 64) of one (S, D) head into an fp32 tile of row
// stride D + 1; rows at or past `s` are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int s) {
  for (int idx = threadIdx.x; idx < BQ * D; idx += THREADS) {
    int r = idx / D, c = idx % D;
    int row = row0 + r;
    dst[r * (D + 1) + c] = row < s ? to_f32(src[(int64_t)row * D + c]) : 0.f;
  }
}

// delta[row] = sum_d o[row, d] * dout[row, d]; one warp per row.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
bwd_preprocess_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                      float* __restrict__ delta, int64_t rows) {
  const int64_t row = (int64_t)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
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

// One block per (q tile, bh): dq for the tile's 64 rows.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int s, int causal, int valid_len,
              float scale) {
  constexpr int ST = D + 1;
  constexpr int DS_ST = BK + 1;
  constexpr int NS = BK / 4;  // keys per thread
  constexpr int NO = D / 4;   // dq columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + BQ * ST;
  float* k_s = do_s + BQ * ST;
  float* v_s = k_s + BK * ST;
  float* ds_s = v_s + BK * ST;

  const int qt = gridDim.x - 1 - blockIdx.x;  // diagonal-most tiles first
  const int bh = blockIdx.y;
  const int64_t head = (int64_t)bh * s * D;
  const int r = threadIdx.x / 4;  // query row within the tile
  const int c = threadIdx.x % 4;  // lane within the quad
  const int row = qt * BQ + r;

  load_tile<T, D>(q_s, q + head, qt * BQ, s);
  load_tile<T, D>(do_s, dout + head, qt * BQ, s);
  const float row_lse = row < s ? lse[(int64_t)bh * s + row] : 0.f;
  const float row_delta = row < s ? delta[(int64_t)bh * s + row] : 0.f;

  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;

  // keys this tile's rows may see: [0, kv_end)
  int kv_end = valid_len < s ? valid_len : s;
  if (causal && qt * BQ + BQ < kv_end) kv_end = qt * BQ + BQ;
  const int n_kt = (kv_end + BK - 1) / BK;

  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();  // the previous tile's k_s / v_s reads are done
    load_tile<T, D>(k_s, k + head, kt * BK, s);
    load_tile<T, D>(v_s, v + head, kt * BK, s);
    __syncthreads();

    float sc[NS], dp[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) sc[i] = dp[i] = 0.f;
    const float* qr = q_s + r * ST;
    const float* dr = do_s + r * ST;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qv = qr[d], dv = dr[d];
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        sc[i] += qv * k_s[(c + 4 * i) * ST + d];
        dp[i] += dv * v_s[(c + 4 * i) * ST + d];
      }
    }

    __syncwarp();  // the quad's previous ds_s row has been read
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int col = kt * BK + c + 4 * i;
      const bool valid = row < s && col < kv_end && (!causal || col <= row);
      const float p = valid ? expf(sc[i] * scale - row_lse) : 0.f;
      ds_s[r * DS_ST + c + 4 * i] = p * (dp[i] - row_delta);
    }
    __syncwarp();  // the quad's ds_s row is written

    const float* dsr = ds_s + r * DS_ST;
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float ds = dsr[j];
#pragma unroll
      for (int i = 0; i < NO; ++i) acc[i] += ds * k_s[j * ST + c + 4 * i];
    }
  }

  if (row < s) {
#pragma unroll
    for (int i = 0; i < NO; ++i)
      dq[head + (int64_t)row * D + c + 4 * i] = from_f32<T>(acc[i] * scale);
  }
}

// One block per (kv tile, bh): dk and dv for the tile's 64 keys.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, int s, int causal,
               int valid_len, float scale) {
  constexpr int ST = D + 1;
  constexpr int P_ST = BQ + 1;
  constexpr int NS = BQ / 4;  // query rows per thread
  constexpr int NO = D / 4;   // dk / dv columns per thread
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + BK * ST;
  float* q_s = v_s + BK * ST;
  float* do_s = q_s + BQ * ST;
  float* p_s = do_s + BQ * ST;
  float* ds_s = p_s + BK * P_ST;
  float* lse_s = ds_s + BK * P_ST;
  float* delta_s = lse_s + BQ;

  const int kt = blockIdx.x;  // the first kv tiles see the most q tiles
  const int bh = blockIdx.y;
  const int64_t head = (int64_t)bh * s * D;
  const int j = threadIdx.x / 4;  // key row within the tile
  const int c = threadIdx.x % 4;  // lane within the quad
  const int key = kt * BK + j;
  const int kv_valid = valid_len < s ? valid_len : s;

  load_tile<T, D>(k_s, k + head, kt * BK, s);
  load_tile<T, D>(v_s, v + head, kt * BK, s);

  float dk_acc[NO], dv_acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  // q tiles whose rows may see this tile's keys: [qt0, n_qt); none when
  // every key of the tile is at or past valid_len
  const int n_qt = (s + BQ - 1) / BQ;
  int qt0 = causal ? (kt * BK) / BQ : 0;
  if (kt * BK >= kv_valid) qt0 = n_qt;

  for (int qt = qt0; qt < n_qt; ++qt) {
    __syncthreads();  // the previous tile's q_s / do_s / lse_s reads are done
    load_tile<T, D>(q_s, q + head, qt * BQ, s);
    load_tile<T, D>(do_s, dout + head, qt * BQ, s);
    if (threadIdx.x < BQ) {
      const int row = qt * BQ + threadIdx.x;
      lse_s[threadIdx.x] = row < s ? lse[(int64_t)bh * s + row] : 0.f;
      delta_s[threadIdx.x] = row < s ? delta[(int64_t)bh * s + row] : 0.f;
    }
    __syncthreads();

    float sc[NS], dp[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) sc[i] = dp[i] = 0.f;
    const float* kr = k_s + j * ST;
    const float* vr = v_s + j * ST;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float kv = kr[d], vv = vr[d];
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        sc[i] += kv * q_s[(c + 4 * i) * ST + d];
        dp[i] += vv * do_s[(c + 4 * i) * ST + d];
      }
    }

    __syncwarp();  // the quad's previous p_s / ds_s rows have been read
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int qi = c + 4 * i;
      const int qrow = qt * BQ + qi;
      const bool valid =
          qrow < s && key < kv_valid && (!causal || key <= qrow);
      const float p = valid ? expf(sc[i] * scale - lse_s[qi]) : 0.f;
      p_s[j * P_ST + qi] = p;
      ds_s[j * P_ST + qi] = p * (dp[i] - delta_s[qi]);
    }
    __syncwarp();  // the quad's p_s / ds_s rows are written

    const float* pr = p_s + j * P_ST;
    const float* dsr = ds_s + j * P_ST;
#pragma unroll 4
    for (int i2 = 0; i2 < BQ; ++i2) {
      const float p = pr[i2], ds = dsr[i2];
#pragma unroll
      for (int o = 0; o < NO; ++o) {
        dv_acc[o] += p * do_s[i2 * ST + c + 4 * o];
        dk_acc[o] += ds * q_s[i2 * ST + c + 4 * o];
      }
    }
  }

  if (key < s) {
#pragma unroll
    for (int o = 0; o < NO; ++o) {
      const int64_t at = head + (int64_t)key * D + c + 4 * o;
      dk[at] = from_f32<T>(dk_acc[o] * scale);
      dv[at] = from_f32<T>(dv_acc[o]);
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
  const int64_t blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
  bwd_preprocess_kernel<T, D><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout),
      static_cast<float*>(delta), rows);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int bh, int s, int causal, int valid_len,
                      cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (4 * BQ * (D + 1) + BQ * (BK + 1));
  cudaError_t err = allow_smem(bwd_dq_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((s + BQ - 1) / BQ, bh);
  bwd_dq_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), s, causal, valid_len, 1.f / std::sqrt((float)D));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int bh, int s, int causal,
                       int valid_len, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (4 * BQ * (D + 1) + 2 * BK * (BQ + 1)
                                       + 2 * BQ);
  cudaError_t err = allow_smem(bwd_dkv_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((s + BK - 1) / BK, bh);
  bwd_dkv_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), s, causal, valid_len,
      1.f / std::sqrt((float)D));
  return cudaGetLastError();
}

}  // namespace

// Each entry point: dtype 0 = float32, 1 = bfloat16; d 64 or 128; returns a
// cudaError_t (0 = launched).  valid_len <= 0 means S.
#define DISPATCH(CALL)                                               \
  do {                                                               \
    if (dtype == 0 && d == 64) return (int)CALL(float, 64);          \
    if (dtype == 0 && d == 128) return (int)CALL(float, 128);        \
    if (dtype == 1 && d == 64) return (int)CALL(__nv_bfloat16, 64);  \
    if (dtype == 1 && d == 128) return (int)CALL(__nv_bfloat16, 128); \
    return (int)cudaErrorInvalidValue;                               \
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
