// Causal flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `flash_attention_fwd` of
// src/repro/kernels/flash_attention/kernel.py (body `_fwd_kernel`, line 96;
// pallas_call at line 168).  Same function: q, k, v (BH, S, D) in fp32 or
// bf16, upcast to fp32 before every product; online softmax (m, l, acc) in
// fp32; keys masked past the causal diagonal and at or past `valid_len`;
// outputs o (BH, S, D) in the input dtype and lse = m + log(l) (BH, S) fp32.
//
// What bounds it on the H100: operations.  Causal attention does about
// 2 * BH * S^2 * D multiply-adds against 4 * BH * S * D elements of traffic,
// so at S = 512, D = 64 it does ~64 operations per byte (fp32), well above
// what the memory feeds.  This first kernel runs its products on the fp32
// CUDA cores (67 TFLOP/s peak), not the tensor cores, and reads its
// operands from shared memory: it is bounded by shared-memory bandwidth
// (about one shared load per multiply-add).  wgmma on bf16 tiles is the
// later, faster version.
//
// Design.  The TPU grid (bh, q_blocks, kv_blocks) ran its kv axis in order
// and carried (m, l, acc) in VMEM scratch; its index map clamped the kv
// block above the diagonal so the fetch was elided.  Here one block owns
// one (q tile, bh) cell and loops over kv tiles itself, only up to the
// diagonal (and up to valid_len), so tiles above it are neither loaded nor
// computed.  The block's 256 threads form 64 quads, one per query row: a
// quad lane scores 16 of the tile's 64 keys and owns D/4 output columns,
// row max and row sum go through two quad shuffles, and the probabilities
// pass to the P.V product through shared memory.  Rows of a ragged last q
// tile and keys of a ragged last kv tile are masked here, so the wrapper
// makes no padded copies.  The heaviest (diagonal-most) q tiles launch
// first.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per kv tile
constexpr int THREADS = 256;  // 4 threads per query row
constexpr float NEG_INF = -1e30f;

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

// Copy rows [row0, row0 + BQ) of one (S, D) head into a padded fp32 tile;
// rows at or past `s` are zero.
template <typename T, int D, int STRIDE>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int s) {
  for (int idx = threadIdx.x; idx < BQ * D; idx += THREADS) {
    int r = idx / D, c = idx % D;
    int row = row0 + r;
    dst[r * STRIDE + c] =
        row < s ? to_f32(src[(int64_t)row * D + c]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int s, int causal, int valid_len,
                 float scale) {
  constexpr int QK_STRIDE = D + 1;  // padded: rows of a warp hit distinct banks
  constexpr int P_STRIDE = BK + 1;
  constexpr int NS = BK / 4;        // scores per thread
  constexpr int NO = D / 4;         // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + BQ * QK_STRIDE;
  float* v_s = k_s + BK * QK_STRIDE;
  float* p_s = v_s + BK * D;

  const int n_qt = gridDim.x;
  const int qt = n_qt - 1 - blockIdx.x;  // diagonal-most tiles first
  const int bh = blockIdx.y;
  const int64_t head = (int64_t)bh * s * D;
  const int r = threadIdx.x / 4;         // query row within the tile
  const int c = threadIdx.x % 4;         // lane within the quad
  const int row = qt * BQ + r;

  load_tile<T, D, QK_STRIDE>(q_s, q + head, qt * BQ, s);

  float m = NEG_INF, l = 0.f;
  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;

  // keys this tile's rows may see: [0, kv_end)
  int kv_end = valid_len < s ? valid_len : s;
  if (causal) {
    int diag = qt * BQ + BQ;  // one past the tile's last row
    if (diag < kv_end) kv_end = diag;
  }
  const int n_kt = (kv_end + BK - 1) / BK;

  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();  // previous tile's k_s / v_s reads are done
    load_tile<T, D, QK_STRIDE>(k_s, k + head, kt * BK, s);
    load_tile<T, D, D>(v_s, v + head, kt * BK, s);
    __syncthreads();

    float sc[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) sc[i] = 0.f;
    const float* qr = q_s + r * QK_STRIDE;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv = qr[d];
#pragma unroll
      for (int i = 0; i < NS; ++i)
        sc[i] += qv * k_s[(c + 4 * i) * QK_STRIDE + d];
    }

    float tile_max = NEG_INF;
    bool valid[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      int col = kt * BK + c + 4 * i;
      valid[i] = col < kv_end && (!causal || col <= row);
      sc[i] *= scale;
      if (valid[i]) tile_max = fmaxf(tile_max, sc[i]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    float psum = 0.f;
    __syncwarp();  // the quad's previous p_s row has been read
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      float p = valid[i] ? expf(sc[i] - m_new) : 0.f;
      psum += p;
      p_s[r * P_STRIDE + c + 4 * i] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();  // the quad's p_s row is written

#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] *= corr;
    const float* pr = p_s + r * P_STRIDE;
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float p = pr[j];
#pragma unroll
      for (int i = 0; i < NO; ++i) acc[i] += p * v_s[j * D + c + 4 * i];
    }
  }

  if (row < s) {
    const float lc = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < NO; ++i)
      o[head + (int64_t)row * D + c + 4 * i] = from_f32<T>(acc[i] / lc);
    if (c == 0) lse[(int64_t)bh * s + row] = m + logf(lc);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int s, int causal, int valid_len,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * BQ * (D + 1) + BK * D + BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((s + BQ - 1) / BQ, bh);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      s, causal, valid_len, 1.f / std::sqrt((float)D));
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
  if (dtype == 0 && d == 128)
    return launch<float, 128>(q, k, v, o, lse, bh, s, causal, valid_len, st);
  if (dtype == 1 && d == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, lse, bh, s, causal,
                                     valid_len, st);
  if (dtype == 1 && d == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, lse, bh, s, causal,
                                      valid_len, st);
  return (int)cudaErrorInvalidValue;
}
