// Split-KV flash-decode for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `flash_decode_fwd` of
// src/repro/kernels/flash_decode/kernel.py (body `_decode_kernel`, line 41;
// pallas_call at line 109).  Same function: one query row per slot, grouped
// q (B, KV, G, D), attends over its (B, S, KV, D) cache rows col < lengths[b]
// ("count of valid entries"), in fp32 whatever the cache dtype; it emits the
// unnormalized fp32 partials o (B, KV, G, D), m (B, KV, G), l (B, KV, G).
// A slot with nothing valid yields (0, -1e30, 0).
//
// What bounds it on the H100: bytes.  Each cache element read feeds G
// multiply-adds, so with G = 1 (gpt2) the kernel does ~0.5 operation per
// byte (fp32) and the least time is 2 * sum(lengths) * KV * D * elt bytes
// over 3.35 TB/s.  The design therefore reads each valid cache row once,
// reads nothing past lengths[b], and keeps enough blocks in flight to use
// the memory: the TPU grid (B, KV, kv_blocks) ran its kv axis in order on
// one core, but B * KV is only 96 for 8 gpt2 slots, under the 132 SMs.  So
// the cache is split along S into chunks of CHUNK keys, one block per
// (chunk, kv head, slot); each block writes its own (o, m, l) partial, and a
// second small kernel merges the chunks with the rule of
// src/repro/kernels/flash_decode/ops.py:60-61
// (gm = max m; o = sum o*exp(m-gm); l = sum l*exp(m-gm)).  A chunk wholly
// past lengths[b] returns before it loads anything, and the merge never
// reads it.  Inside a block each warp takes every fourth key, a lane holds
// D/32 elements at stride 32 (each load instruction of a warp reads one
// contiguous row segment), dot products reduce through warp shuffles,
// softmax runs per chunk in shared memory, and the four warps' P.V sums
// meet in shared memory.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int CHUNK = 128;   // keys per block
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int UNROLL = 4;    // keys in flight per warp
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(THREADS)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    float* __restrict__ po, float* __restrict__ pm,
                    float* __restrict__ pl, int s, int kvh, int n_splits,
                    int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
                    int64_t v_ss, int64_t v_sh, float scale) {
  constexpr int E = D / 32;  // elements per lane, at stride 32
  __shared__ float p_s[G][CHUNK];
  __shared__ float red[WARPS][G][D];
  __shared__ float m_s[G], l_s[G];

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int len = lengths[b];
  if (len > s) len = s;
  const int col0 = split * CHUNK;
  if (col0 >= len) return;  // wholly past the slot's valid length
  const int n = min(CHUNK, len - col0);

  const int64_t cell = (int64_t)b * kvh + h;  // (slot, kv head)
  float qr[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < E; ++e)
      qr[g][e] = to_f32(q[(cell * G + g) * D + lane + 32 * e]);

  const T* kb = k + b * k_sb + h * k_sh + (int64_t)col0 * k_ss;
  const T* vb = v + b * v_sb + h * v_sh + (int64_t)col0 * v_ss;

  // scores: s = (q . k) * scale, one key per warp per unrolled slot
  for (int j0 = warp; j0 < n; j0 += WARPS * UNROLL) {
    float kr[UNROLL][E];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + u * WARPS;
#pragma unroll
      for (int e = 0; e < E; ++e)
        kr[u][e] = j < n ? to_f32(kb[j * k_ss + lane + 32 * e]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + u * WARPS;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) dot += qr[g][e] * kr[u][e];
        dot = warp_sum(dot);
        if (lane == 0 && j < n) p_s[g][j] = dot * scale;
      }
    }
  }
  __syncthreads();

  // softmax over this chunk's n valid keys, one warp per query row
  for (int g = warp; g < G; g += WARPS) {
    float mx = NEG_INF;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, p_s[g][j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = expf(p_s[g][j] - mx);
      p_s[g][j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      m_s[g] = mx;
      l_s[g] = sum;
    }
  }
  __syncthreads();

  // o = P . V, each warp over its keys, then summed across warps
  float acc[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  for (int j0 = warp; j0 < n; j0 += WARPS * UNROLL) {
    float vr[UNROLL][E];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + u * WARPS;
#pragma unroll
      for (int e = 0; e < E; ++e)
        vr[u][e] = j < n ? to_f32(vb[j * v_ss + lane + 32 * e]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + u * WARPS;
      if (j < n) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float p = p_s[g][j];
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] += p * vr[u][e];
        }
      }
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < E; ++e) red[warp][g][lane + 32 * e] = acc[g][e];
  __syncthreads();

  const int64_t part = cell * n_splits + split;
  for (int idx = threadIdx.x; idx < G * D; idx += THREADS) {
    const int g = idx / D, d = idx % D;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += red[w][g][d];
    po[part * G * D + idx] = sum;
  }
  if (threadIdx.x < G) {
    pm[part * G + threadIdx.x] = m_s[threadIdx.x];
    pl[part * G + threadIdx.x] = l_s[threadIdx.x];
  }
}

// Merge the chunk partials of one (slot, kv head): block of D threads.
__global__ void decode_merge_kernel(const int* __restrict__ lengths,
                                    const float* __restrict__ po,
                                    const float* __restrict__ pm,
                                    const float* __restrict__ pl,
                                    float* __restrict__ o,
                                    float* __restrict__ m,
                                    float* __restrict__ l, int s, int kvh,
                                    int g_size, int d_size, int n_splits) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  int len = lengths[b];
  if (len > s) len = s;
  const int n_valid = len > 0 ? (len + CHUNK - 1) / CHUNK : 0;
  const int64_t cell = (int64_t)b * kvh + h;
  for (int g = 0; g < g_size; ++g) {
    float gm = NEG_INF;
    for (int sp = 0; sp < n_valid; ++sp)
      gm = fmaxf(gm, pm[(cell * n_splits + sp) * g_size + g]);
    float o_acc = 0.f, l_acc = 0.f;
    for (int sp = 0; sp < n_valid; ++sp) {
      const int64_t part = cell * n_splits + sp;
      const float w = expf(pm[part * g_size + g] - gm);
      o_acc += po[(part * g_size + g) * d_size + d] * w;
      l_acc += pl[part * g_size + g] * w;
    }
    o[(cell * g_size + g) * d_size + d] = o_acc;
    if (d == 0) {
      m[cell * g_size + g] = gm;
      l[cell * g_size + g] = l_acc;
    }
  }
}

template <typename T, int D, int G>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, float* po, float* pm, float* pl, int b,
                   int s, int kvh, int n_splits, const int64_t* ks,
                   const int64_t* vs, cudaStream_t stream) {
  dim3 grid(n_splits, kvh, b);
  decode_split_kernel<T, D, G><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, po, pm, pl, s, kvh, n_splits, ks[0],
      ks[1], ks[2], vs[0], vs[1], vs[2], 1.f / std::sqrt((float)D));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_g(int g, const void* q, const void* k, const void* v,
                     const int* lengths, float* po, float* pm, float* pl,
                     int b, int s, int kvh, int n_splits, const int64_t* ks,
                     const int64_t* vs, cudaStream_t st) {
  switch (g) {
    case 1: return launch<T, D, 1>(q, k, v, lengths, po, pm, pl, b, s, kvh,
                                   n_splits, ks, vs, st);
    case 2: return launch<T, D, 2>(q, k, v, lengths, po, pm, pl, b, s, kvh,
                                   n_splits, ks, vs, st);
    case 4: return launch<T, D, 4>(q, k, v, lengths, po, pm, pl, b, s, kvh,
                                   n_splits, ks, vs, st);
    case 8: return launch<T, D, 8>(q, k, v, lengths, po, pm, pl, b, s, kvh,
                                   n_splits, ks, vs, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Keys per split, for the wrapper's scratch sizing.
extern "C" int flash_decode_chunk() { return CHUNK; }

// q (B, KV, G, D) contiguous; k, v (B, S, KV, D) with unit stride on D and
// element strides (b, s, h) in k_strides / v_strides; lengths (B,) int32.
// Scratch po (B, KV, n_splits, G, D), pm / pl (B, KV, n_splits, G) fp32,
// n_splits = ceil(S / CHUNK).  Outputs o (B, KV, G, D), m / l (B, KV, G)
// fp32.  dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t.
extern "C" int flash_decode_fwd(const void* q, const void* k, const void* v,
                                const void* lengths, void* po, void* pm,
                                void* pl, void* o, void* m, void* l, int b,
                                int s, int kvh, int g, int d,
                                int64_t k_sb, int64_t k_ss, int64_t k_sh,
                                int64_t v_sb, int64_t v_ss, int64_t v_sh,
                                int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_splits = (s + CHUNK - 1) / CHUNK;
  const int64_t ks[3] = {k_sb, k_ss, k_sh}, vs[3] = {v_sb, v_ss, v_sh};
  const int* len = static_cast<const int*>(lengths);
  float *fpo = static_cast<float*>(po), *fpm = static_cast<float*>(pm),
        *fpl = static_cast<float*>(pl);
  cudaError_t err;
  if (dtype == 0 && d == 64)
    err = launch_g<float, 64>(g, q, k, v, len, fpo, fpm, fpl, b, s, kvh,
                              n_splits, ks, vs, st);
  else if (dtype == 0 && d == 128)
    err = launch_g<float, 128>(g, q, k, v, len, fpo, fpm, fpl, b, s, kvh,
                               n_splits, ks, vs, st);
  else if (dtype == 1 && d == 64)
    err = launch_g<__nv_bfloat16, 64>(g, q, k, v, len, fpo, fpm, fpl, b, s,
                                      kvh, n_splits, ks, vs, st);
  else if (dtype == 1 && d == 128)
    err = launch_g<__nv_bfloat16, 128>(g, q, k, v, len, fpo, fpm, fpl, b, s,
                                       kvh, n_splits, ks, vs, st);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  decode_merge_kernel<<<dim3(kvh, b), d, 0, st>>>(
      len, fpo, fpm, fpl, static_cast<float*>(o), static_cast<float*>(m),
      static_cast<float*>(l), s, kvh, g, d, n_splits);
  return (int)cudaGetLastError();
}
