// The default AdamW chain of repro_torch.optim.transforms as two passes over a
// table of fp32 leaves, updating the parameters and both moments in place.
//
// Replaces no TPU kernel: the reference leaves its optimizer to XLA, which
// fuses the chain into the jitted step.  Eagerly, the port's chain made some
// twenty foreach passes over the state a step (clip, the Adam moments, two
// params-sized temporaries, the variance statistics, decay, LR, the update):
// about 39 reads or writes of the parameters' size.
//
//   pass 1  sum of g^2 over every leaf, one partial a block;
//   finish  grad_norm, the clip scale min(1, limit / max(grad_norm, 1e-12)),
//           count + 1 and both bias corrections, on the device;
//   pass 2  per element, in registers: g *= scale; m = b1 m + (1-b1) g;
//           v = b2 v + (1-b2) g^2; u = (m / bc1) / (sqrt(v / bc2) + eps)
//           (+ wd p on decayed leaves); p -= u * lr (times the leaf's group
//           factor where one is given); p, m, v stored; block partials of
//           sum sqrt(v), max v and sum |m|;
//   finish  var_l1, var_max = sqrt(max v), mom_l1.
//
// Bound: bytes.  Pass 1 reads g (N floats), pass 2 reads p, g, m, v and
// writes p, m, v: 8 N x 4 bytes, 88.7 GB for 2.771 B parameters, 26.5 ms
// at 3.35 TB/s (7 N if g were read once, which the global clip forbids).
// Arithmetic is ~40 instructions an element (two IEEE divisions, two
// square roots), far under the bytes.  Design: persistent blocks walk a
// table of fixed 16,384-element chunks, each (leaf, chunk index), built once
// per parameter set; a chunk goes by float4 where its four pointers are
// 16-byte aligned, with a scalar tail.  The grid is fixed for a card (SMs x
// resident blocks), every partial lands in its own slot, and the finishes
// sum them in a fixed order in double: no float atomics, so a run and its
// resume are bit-identical.  Non-finite values propagate as in the chain
// (the maxima keep NaN; a NaN norm makes a NaN clip scale).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 16384;   // elements a chunk (a multiple of 4)
constexpr int THREADS = 256;   // threads a block of either pass
constexpr int FINISH = 1024;   // threads of a finishing block
constexpr int MAX_GRID = 4096; // partial slots the wrapper allocates

// one row of the leaf table, as the wrapper lays it out: int64 x 5
struct Leaf {
  float* p;
  float* m;
  float* v;
  long long n;
  long long flags;  // bit 0: weight decay; bits 1-: the leaf's group
};

struct Hyper {
  float lr, b1, b2, omb1, omb2, eps, wd;
};

__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

struct Sum {
  __device__ double operator()(double a, double b) const { return a + b; }
};

struct NanMax {
  __device__ float operator()(float a, float b) const { return nan_max(a, b); }
};

// Thread 0 gets the block's reduction of x; the order is fixed by the lanes
// and warps, so it repeats bit for bit.
template <typename T, typename Op>
__device__ T block_reduce(T x, T identity, T* smem, Op op) {
  for (int o = 16; o > 0; o >>= 1) x = op(x, __shfl_down_sync(0xffffffffu, x, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) smem[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < (int)(blockDim.x >> 5) ? smem[lane] : identity;
    for (int o = 16; o > 0; o >>= 1)
      x = op(x, __shfl_down_sync(0xffffffffu, x, o));
  }
  __syncthreads();  // smem may be reused by the caller
  return x;
}

__device__ __forceinline__ void chunk_of(const int2* chunks, const Leaf* leaves,
                                         int c, int& leaf, long long& start,
                                         int& len) {
  const int2 ck = chunks[c];
  leaf = ck.x;
  start = (long long)ck.y * CHUNK;
  const long long left = leaves[leaf].n - start;
  len = (int)(left < CHUNK ? left : CHUNK);
}

__device__ __forceinline__ void add_sq(double& acc, float x) {
  acc = fma((double)x, (double)x, acc);
}

__global__ void __launch_bounds__(THREADS)
norm_pass(const int2* __restrict__ chunks, int nchunks,
          const Leaf* __restrict__ leaves, const float* const* __restrict__ grads,
          double* __restrict__ part) {
  __shared__ double red[32];
  double acc = 0.0;
  for (int c = blockIdx.x; c < nchunks; c += gridDim.x) {
    int leaf, len;
    long long start;
    chunk_of(chunks, leaves, c, leaf, start, len);
    const float* __restrict__ g = grads[leaf] + start;
    const int n4 = ((uintptr_t)g & 15) == 0 ? len >> 2 : 0;
    const float4* __restrict__ g4 = reinterpret_cast<const float4*>(g);
    for (int i = threadIdx.x; i < n4; i += THREADS) {
      const float4 x = __ldg(g4 + i);
      add_sq(acc, x.x);
      add_sq(acc, x.y);
      add_sq(acc, x.z);
      add_sq(acc, x.w);
    }
    for (int i = 4 * n4 + threadIdx.x; i < len; i += THREADS) add_sq(acc, __ldg(g + i));
  }
  acc = block_reduce(acc, 0.0, red, Sum());
  if (threadIdx.x == 0) part[blockIdx.x] = acc;
}

// out[0] grad_norm, out[1] grad_norm_clipped; scal = {clip scale, bc1, bc2}
__global__ void __launch_bounds__(FINISH)
norm_finish(const double* __restrict__ part, int nparts,
            const int* __restrict__ count_in, int* __restrict__ count_out,
            float* __restrict__ out, float* __restrict__ scal, int clip,
            float limit, float b1, float b2) {
  __shared__ double red[32];
  double s = 0.0;
  for (int i = threadIdx.x; i < nparts; i += FINISH) s += part[i];
  s = block_reduce(s, 0.0, red, Sum());
  if (threadIdx.x != 0) return;
  const float gnorm = (float)sqrt(s);
  float scale = 1.0f;
  if (clip) {
    // the chain's limit / norm is torch's reciprocal, then a product
    const float x = __fmul_rn(__frcp_rn(gnorm < 1e-12f ? 1e-12f : gnorm), limit);
    scale = x > 1.0f ? 1.0f : x;  // a NaN stays NaN, as torch.clamp keeps it
  }
  const int count = *count_in + 1;
  *count_out = count;
  scal[0] = scale;
  scal[1] = 1.0f - powf(b1, (float)count);
  scal[2] = 1.0f - powf(b2, (float)count);
  out[0] = gnorm;
  out[1] = __fmul_rn(gnorm, scale);
}

struct Stats {
  double sv, sm;  // sum sqrt(v), sum |m|
  float vmax;
};

// one element, in the chain's order of roundings
__device__ __forceinline__ void adam(float& p, float g, float& m, float& v,
                                     const Hyper& h, float scale, float bc1,
                                     float bc2, bool decay, float factor,
                                     Stats& st) {
  g = __fmul_rn(g, scale);
  m = __fmaf_rn(h.omb1, g, __fmul_rn(m, h.b1));
  v = __fmaf_rn(h.omb2, __fmul_rn(g, g), __fmul_rn(v, h.b2));
  float u = __fdiv_rn(__fdiv_rn(m, bc1),
                      __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), h.eps));
  if (decay) u = __fmaf_rn(h.wd, p, u);
  p = __fsub_rn(p, __fmul_rn(u, factor));
  st.sv += (double)__fsqrt_rn(v);
  st.sm += (double)fabsf(m);
  st.vmax = nan_max(st.vmax, v);
}

__global__ void __launch_bounds__(THREADS)
update_pass(const int2* __restrict__ chunks, int nchunks,
            const Leaf* __restrict__ leaves, const float* const* __restrict__ grads,
            const float* __restrict__ scal, const float* __restrict__ lr_scale,
            Hyper h, double* __restrict__ part) {
  __shared__ double red[32];
  __shared__ float redf[32];
  const float scale = scal[0], bc1 = scal[1], bc2 = scal[2];
  Stats st{0.0, 0.0, 0.0f};
  for (int c = blockIdx.x; c < nchunks; c += gridDim.x) {
    int leaf, len;
    long long start;
    chunk_of(chunks, leaves, c, leaf, start, len);
    const Leaf L = leaves[leaf];
    const bool decay = L.flags & 1;
    const float factor =
        lr_scale ? __fmul_rn(h.lr, lr_scale[L.flags >> 1]) : h.lr;
    float* __restrict__ p = L.p + start;
    float* __restrict__ m = L.m + start;
    float* __restrict__ v = L.v + start;
    const float* __restrict__ g = grads[leaf] + start;
    const bool aligned =
        (((uintptr_t)p | (uintptr_t)m | (uintptr_t)v | (uintptr_t)g) & 15) == 0;
    const int n4 = aligned ? len >> 2 : 0;
    float4* __restrict__ p4 = reinterpret_cast<float4*>(p);
    float4* __restrict__ m4 = reinterpret_cast<float4*>(m);
    float4* __restrict__ v4 = reinterpret_cast<float4*>(v);
    const float4* __restrict__ g4 = reinterpret_cast<const float4*>(g);
    for (int i = threadIdx.x; i < n4; i += THREADS) {
      float4 pp = p4[i], mm = m4[i], vv = v4[i];
      const float4 gg = __ldg(g4 + i);
      adam(pp.x, gg.x, mm.x, vv.x, h, scale, bc1, bc2, decay, factor, st);
      adam(pp.y, gg.y, mm.y, vv.y, h, scale, bc1, bc2, decay, factor, st);
      adam(pp.z, gg.z, mm.z, vv.z, h, scale, bc1, bc2, decay, factor, st);
      adam(pp.w, gg.w, mm.w, vv.w, h, scale, bc1, bc2, decay, factor, st);
      p4[i] = pp;
      m4[i] = mm;
      v4[i] = vv;
    }
    for (int i = 4 * n4 + threadIdx.x; i < len; i += THREADS) {
      float pp = p[i], mm = m[i], vv = v[i];
      adam(pp, __ldg(g + i), mm, vv, h, scale, bc1, bc2, decay, factor, st);
      p[i] = pp;
      m[i] = mm;
      v[i] = vv;
    }
  }
  const double sv = block_reduce(st.sv, 0.0, red, Sum());
  const double sm = block_reduce(st.sm, 0.0, red, Sum());
  const float vmax = block_reduce(st.vmax, 0.0f, redf, NanMax());
  if (threadIdx.x == 0) {
    part[3 * blockIdx.x] = sv;
    part[3 * blockIdx.x + 1] = sm;
    part[3 * blockIdx.x + 2] = (double)vmax;
  }
}

// out[2] var_l1, out[3] var_max, out[4] mom_l1
__global__ void __launch_bounds__(FINISH)
update_finish(const double* __restrict__ part, int nparts, float* __restrict__ out) {
  __shared__ double red[32];
  __shared__ float redf[32];
  double sv = 0.0, sm = 0.0;
  float vmax = 0.0f;
  for (int i = threadIdx.x; i < nparts; i += FINISH) {
    sv += part[3 * i];
    sm += part[3 * i + 1];
    vmax = nan_max(vmax, (float)part[3 * i + 2]);
  }
  sv = block_reduce(sv, 0.0, red, Sum());
  sm = block_reduce(sm, 0.0, red, Sum());
  vmax = block_reduce(vmax, 0.0f, redf, NanMax());
  if (threadIdx.x == 0) {
    out[2] = (float)sv;
    out[3] = __fsqrt_rn(vmax);
    out[4] = (float)sm;
  }
}

}  // namespace

extern "C" int fused_adamw_chunk(void) { return CHUNK; }

extern "C" int fused_adamw_max_grid(void) { return MAX_GRID; }

// part: 4 x MAX_GRID doubles of scratch; scal: 3 floats of scratch; out: 5
// floats; lr_scale: NULL or one float a group.
extern "C" int fused_adamw(const void* leaves, const void* chunks, int nchunks,
                           const void* grads, const int* count_in,
                           int* count_out, float* out, float* scal,
                           double* part, const float* lr_scale, int clip,
                           float limit, float lr, float b1, float b2,
                           float omb1, float omb2, float eps, float wd,
                           void* stream) {
  if (nchunks < 0) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0, resident = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, update_pass,
                                                        THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  int grid = sms * (resident > 0 ? resident : 1);
  if (grid > MAX_GRID) grid = MAX_GRID;
  if (grid > nchunks) grid = nchunks > 0 ? nchunks : 1;
  const auto* lt = static_cast<const Leaf*>(leaves);
  const auto* ck = static_cast<const int2*>(chunks);
  const auto* gp = static_cast<const float* const*>(grads);
  norm_pass<<<grid, THREADS, 0, st>>>(ck, nchunks, lt, gp, part);
  norm_finish<<<1, FINISH, 0, st>>>(part, grid, count_in, count_out, out, scal,
                                    clip, limit, b1, b2);
  const Hyper h{lr, b1, b2, omb1, omb2, eps, wd};
  update_pass<<<grid, THREADS, 0, st>>>(ck, nchunks, lt, gp, scal, lr_scale, h,
                                        part + MAX_GRID);
  update_finish<<<1, FINISH, 0, st>>>(part + MAX_GRID, grid, out);
  return (int)cudaGetLastError();
}
