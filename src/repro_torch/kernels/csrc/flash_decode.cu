// Split-KV flash-decode for Hopper (sm_90a), dense and paged, plain C
// interface.
//
// Replaces two TPU kernels of src/repro/kernels/flash_decode/kernel.py:
//   * `flash_decode_fwd` (body `_decode_kernel`, line 41; pallas_call at
//     line 109): one query row per slot, grouped q (B, KV, G, D), attends
//     over its (B, S, KV, D) cache rows col < lengths[b] ("count of valid
//     entries");
//   * `flash_decode_paged_fwd` (body `_paged_decode_kernel`, line 142;
//     pallas_call at line 247): the same over shared (n_pages, page_size,
//     KV, D) pools, slot b's token j living in page page_table[b, j / ps]
//     at offset j % ps; -1 marks an unowned page, which is never read.
// Both compute in fp32 whatever the cache dtype and emit the unnormalized
// fp32 partials o (B, KV, G, D), m (B, KV, G), l (B, KV, G).  A slot with
// nothing valid yields (0, -1e30, 0).
//
// What bounds them on the H100: bytes.  Each cache element read feeds G
// multiply-adds, so with G = 1 (gpt2) a kernel does ~0.5 operation per
// byte (fp32) and the least time is 2 * sum(lengths) * KV * D * elt bytes
// over 3.35 TB/s.  The design therefore reads each valid cache row once,
// reads nothing past lengths[b], and keeps enough blocks in flight to use
// the memory: the TPU grids (B, KV, kv_blocks) and (B, KV, max_pages) ran
// their last axis in order on one core, but B * KV is only 96 for 8 gpt2
// slots, under the 132 SMs.  So the logical cache is split into chunks of
// CHUNK keys, one block per (chunk, kv head, slot); each block writes its
// own (o, m, l) partial, and a second small kernel merges the chunks with
// the rule of src/repro/kernels/flash_decode/ops.py:60-61
// (gm = max m; o = sum o*exp(m-gm); l = sum l*exp(m-gm)).  A chunk wholly
// past lengths[b] returns before it loads anything, and the merge never
// reads it.  Inside a block each warp takes every fourth key, a lane holds
// D/32 elements at stride 32 (each load instruction of a warp reads one
// contiguous row segment), dot products reduce through warp shuffles,
// softmax runs per chunk in shared memory, and the four warps' P.V sums
// meet in shared memory.
//
// The paged kernel differs only in where key j of a chunk lives: the block
// stages the page ids its chunk spans in shared memory once (a chunk of
// 128 keys spans at most 128 / page_size + 1 pages), then addresses key j
// through them.  Neither the k nor the v row of an unowned key is loaded:
// inside the slot's length it counts as a zero key and value, as in the
// plain version (the reference's oracle, `gather_pages`, zeroes unowned
// pages); the TPU kernel skips such a page instead.  The two agree on
// every row whose unowned entries lie at or past its length, which is
// every live row of the engine; its inactive rows (length 1, no page)
// give (0, 0, 1) here and (0, -1e30, 0) on the TPU, and nobody reads
// them.  A table entry past the slot's length is never read.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <cmath>
#include <type_traits>

namespace {

constexpr int CHUNK = 128;   // keys per block
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int UNROLL = 4;    // keys in flight per warp
constexpr float NEG_INF = -1e30f;

template <int N>
using Int = std::integral_constant<int, N>;

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

// Key j of a chunk in a dense (B, S, KV, D) cache: k and v point at the
// chunk's first row of this (slot, kv head).
template <typename T>
struct DenseRows {
  const T* k;
  const T* v;
  int64_t k_ss, v_ss;
  __device__ bool owned(int) const { return true; }
  __device__ const T* key(int j) const { return k + j * k_ss; }
  __device__ const T* value(int j) const { return v + j * v_ss; }
};

// Key j of a chunk in a paged pool: k and v point at this kv head's
// column of page 0; pid holds the page ids of the chunk's pages, the first
// of them logical page page0.
template <typename T>
struct PagedRows {
  const T* k;
  const T* v;
  const int* pid;
  int col0, page0, ps;
  int64_t k_sp, k_so, v_sp, v_so;
  __device__ int page(int j) const { return pid[(col0 + j) / ps - page0]; }
  __device__ bool owned(int j) const { return page(j) >= 0; }
  __device__ const T* key(int j) const {
    return k + page(j) * k_sp + ((col0 + j) % ps) * k_so;
  }
  __device__ const T* value(int j) const {
    return v + page(j) * v_sp + ((col0 + j) % ps) * v_so;
  }
};

// One block's chunk of n (>= 1) keys of one (slot, kv head) `cell`:
// scores, chunk softmax, P.V, and the chunk's partial written at `part`.
template <typename T, int D, int G, class Rows>
__device__ __forceinline__ void split_body(const T* __restrict__ q,
                                           const Rows& rows, int n,
                                           int64_t cell, int64_t part,
                                           float* __restrict__ po,
                                           float* __restrict__ pm,
                                           float* __restrict__ pl,
                                           float scale) {
  constexpr int E = D / 32;  // elements per lane, at stride 32
  __shared__ float p_s[G][CHUNK];
  __shared__ float red[WARPS][G][D];
  __shared__ float m_s[G], l_s[G];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  float qr[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < E; ++e)
      qr[g][e] = to_f32(q[(cell * G + g) * D + lane + 32 * e]);

  // scores: s = (q . k) * scale, one key per warp per unrolled slot;
  // an unowned key is a zero key, not loaded
  for (int j0 = warp; j0 < n; j0 += WARPS * UNROLL) {
    float kr[UNROLL][E];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + u * WARPS;
      const bool ok = j < n && rows.owned(j);
      const T* row = ok ? rows.key(j) : nullptr;
#pragma unroll
      for (int e = 0; e < E; ++e)
        kr[u][e] = ok ? to_f32(row[lane + 32 * e]) : 0.f;
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

  // softmax over this chunk's n keys, one warp per query row
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
      const bool ok = j < n && rows.owned(j);
      const T* row = ok ? rows.value(j) : nullptr;
#pragma unroll
      for (int e = 0; e < E; ++e)
        vr[u][e] = ok ? to_f32(row[lane + 32 * e]) : 0.f;
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

template <typename T, int D, int G>
__global__ void __launch_bounds__(THREADS)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    float* __restrict__ po, float* __restrict__ pm,
                    float* __restrict__ pl, int s, int kvh, int n_splits,
                    int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
                    int64_t v_ss, int64_t v_sh, float scale) {
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int len = min(lengths[b], s);
  const int col0 = split * CHUNK;
  if (col0 >= len) return;  // wholly past the slot's valid length
  const int64_t cell = (int64_t)b * kvh + h;  // (slot, kv head)
  const DenseRows<T> rows{k + b * k_sb + h * k_sh + (int64_t)col0 * k_ss,
                          v + b * v_sb + h * v_sh + (int64_t)col0 * v_ss,
                          k_ss, v_ss};
  split_body<T, D, G>(q, rows, min(CHUNK, len - col0), cell,
                      cell * n_splits + split, po, pm, pl, scale);
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(THREADS)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ table,
                   const int* __restrict__ lengths, float* __restrict__ po,
                   float* __restrict__ pm, float* __restrict__ pl,
                   int max_pages, int ps, int kvh, int n_splits, int64_t k_sp,
                   int64_t k_so, int64_t k_sh, int64_t v_sp, int64_t v_so,
                   int64_t v_sh, float scale) {
  __shared__ int pid_s[CHUNK + 1];
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int len = min(lengths[b], max_pages * ps);
  const int col0 = split * CHUNK;
  if (col0 >= len) return;  // wholly past the slot's valid length
  const int n = min(CHUNK, len - col0);
  // the chunk's pages, logical page0 .. page0 + n_pages - 1, all below
  // ceil(len / ps) <= max_pages: no table entry past the length is read
  const int page0 = col0 / ps;
  const int n_pages = (col0 + n - 1) / ps - page0 + 1;
  for (int i = threadIdx.x; i < n_pages; i += THREADS)
    pid_s[i] = table[(int64_t)b * max_pages + page0 + i];
  __syncthreads();
  const int64_t cell = (int64_t)b * kvh + h;
  const PagedRows<T> rows{k + h * k_sh, v + h * v_sh, pid_s, col0, page0, ps,
                          k_sp, k_so, v_sp, v_so};
  split_body<T, D, G>(q, rows, n, cell, cell * n_splits + split, po, pm, pl,
                      scale);
}

// Merge the chunk partials of one (slot, kv head): block of D threads.
// ``s`` is the logical cache length (max_pages * page_size when paged).
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

// Call launch(T(), Int<D>(), Int<G>()) for a supported (dtype, d, g);
// return the launch's error, or cudaErrorInvalidValue for another shape.
template <typename T, int D, class F>
bool by_group(int g, F& launch) {
  switch (g) {
    case 1: launch(T(), Int<D>(), Int<1>()); return true;
    case 2: launch(T(), Int<D>(), Int<2>()); return true;
    case 4: launch(T(), Int<D>(), Int<4>()); return true;
    case 8: launch(T(), Int<D>(), Int<8>()); return true;
    default: return false;
  }
}

template <class F>
cudaError_t dispatch(int dtype, int d, int g, F launch) {
  bool ok = false;
  if (dtype == 0 && d == 64) ok = by_group<float, 64>(g, launch);
  else if (dtype == 0 && d == 128) ok = by_group<float, 128>(g, launch);
  else if (dtype == 1 && d == 64) ok = by_group<__nv_bfloat16, 64>(g, launch);
  else if (dtype == 1 && d == 128) ok = by_group<__nv_bfloat16, 128>(g, launch);
  return ok ? cudaGetLastError() : cudaErrorInvalidValue;
}

cudaError_t merge(const void* lengths, void* po, void* pm, void* pl, void* o,
                  void* m, void* l, int b, int s, int kvh, int g, int d,
                  int n_splits, cudaStream_t st) {
  decode_merge_kernel<<<dim3(kvh, b), d, 0, st>>>(
      static_cast<const int*>(lengths), static_cast<const float*>(po),
      static_cast<const float*>(pm), static_cast<const float*>(pl),
      static_cast<float*>(o), static_cast<float*>(m), static_cast<float*>(l),
      s, kvh, g, d, n_splits);
  return cudaGetLastError();
}

}  // namespace

// Keys per split, for the wrapper's scratch sizing.
extern "C" int flash_decode_chunk() { return CHUNK; }

// q (B, KV, G, D) contiguous; k, v (B, S, KV, D) with unit stride on D and
// element strides (b, s, h) in k_s* / v_s*; lengths (B,) int32.
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
  const dim3 grid(n_splits, kvh, b);
  const float scale = 1.f / std::sqrt((float)d);
  cudaError_t err = dispatch(dtype, d, g, [&](auto t, auto dd, auto gg) {
    using T = decltype(t);
    decode_split_kernel<T, decltype(dd)::value, decltype(gg)::value>
        <<<grid, THREADS, 0, st>>>(
            static_cast<const T*>(q), static_cast<const T*>(k),
            static_cast<const T*>(v), static_cast<const int*>(lengths),
            static_cast<float*>(po), static_cast<float*>(pm),
            static_cast<float*>(pl), s, kvh, n_splits, k_sb, k_ss, k_sh,
            v_sb, v_ss, v_sh, scale);
  });
  if (err != cudaSuccess) return (int)err;
  return (int)merge(lengths, po, pm, pl, o, m, l, b, s, kvh, g, d, n_splits,
                    st);
}

// q (B, KV, G, D) contiguous; k, v pools (n_pages, page_size, KV, D) with
// unit stride on D and element strides (page, offset, h) in k_s* / v_s*;
// page_table (B, max_pages) int32 contiguous, -1 = unowned, every other
// entry a page id below n_pages; lengths (B,) int32, clamped to
// max_pages * page_size.  Scratch and outputs as flash_decode_fwd with
// n_splits = ceil(max_pages * page_size / CHUNK).  Returns a cudaError_t.
extern "C" int flash_decode_paged_fwd(
    const void* q, const void* k, const void* v, const void* page_table,
    const void* lengths, void* po, void* pm, void* pl, void* o, void* m,
    void* l, int b, int max_pages, int page_size, int kvh, int g, int d,
    int64_t k_sp, int64_t k_so, int64_t k_sh, int64_t v_sp, int64_t v_so,
    int64_t v_sh, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int s = max_pages * page_size;
  const int n_splits = (s + CHUNK - 1) / CHUNK;
  const dim3 grid(n_splits, kvh, b);
  const float scale = 1.f / std::sqrt((float)d);
  cudaError_t err = dispatch(dtype, d, g, [&](auto t, auto dd, auto gg) {
    using T = decltype(t);
    paged_split_kernel<T, decltype(dd)::value, decltype(gg)::value>
        <<<grid, THREADS, 0, st>>>(
            static_cast<const T*>(q), static_cast<const T*>(k),
            static_cast<const T*>(v), static_cast<const int*>(page_table),
            static_cast<const int*>(lengths), static_cast<float*>(po),
            static_cast<float*>(pm), static_cast<float*>(pl), max_pages,
            page_size, kvh, n_splits, k_sp, k_so, k_sh, v_sp, v_so, v_sh,
            scale);
  });
  if (err != cudaSuccess) return (int)err;
  return (int)merge(lengths, po, pm, pl, o, m, l, b, s, kvh, g, d, n_splits,
                    st);
}
