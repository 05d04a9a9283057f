// Device helpers shared by the Hopper (sm_90a) kernels of this directory:
// asynchronous copies, error-compensated TF32 and bf16 products on
// mma.sync, and the scalar odds and ends around them.  Included by
// flash_attention_fwd.cu, flash_attention_bwd.cu, flash_decode.cu, ssd.cu
// and wkv6.cu; each builds into a library of its own, so everything here
// has internal linkage.
//
// Error-compensated TF32: an fp32 operand x is split into hi = tf32(x)
// (cvt.rna) and lo = tf32(x - hi), and a product is a_lo b_hi + a_hi b_lo
// + a_hi b_hi, accumulated in fp32 (~2^-21 relative).  An operand that is
// exact in TF32 (a bf16 value) has lo = 0 and its lo product is skipped.
// The tensor cores truncate their sums, so a long sum is taken in fresh
// accumulators added in round-to-nearest fp32 (add_to).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// conversions and stores
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// max(a, b) that returns NaN when either is NaN (max.NaN.f32), the flash
// forward's and the flash-decode kernels' maxima: fmaxf drops a NaN
// operand, so a NaN score would leave the running max, l and lse (or the
// partial's m) finite where the plain versions (torch.amax) and the
// reference (jnp.maximum) give NaN.  One instruction, as fmaxf, and the
// same value as fmaxf on any two numbers (up to the sign of a zero).
__device__ __forceinline__ float max_nan(float a, float b) {
  float y;
  asm("max.NaN.f32 %0, %1, %2;\n" : "=f"(y) : "f"(a), "f"(b));
  return y;
}

// 2^x (ex2.approx, ~2^-22 relative; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// a where c, else b, by selp in registers: the compiler folds a plain
// select between two elements of a register array into an index into the
// array, which puts the whole array in local memory
__device__ __forceinline__ float select_reg(bool c, float a, float b) {
  float r;
  asm("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %3, 0;\n\t"
      "selp.f32 %0, %1, %2, p;\n\t}\n"
      : "=f"(r)
      : "f"(a), "f"(b), "r"((int)c));
  return r;
}

// ---------------------------------------------------------------------------
// copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !full (nothing is read then)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the phases of the cluster's barrier: arrive without ordering anything
// (at a kernel's start, so that a later wait proves every block of the
// cluster runs and its shared memory exists), and wait
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// 16 bytes as fp32 values: 4 fp32, or 8 bf16 (exact: a bf16's bits are the
// high half of its fp32's), the lower address first
__device__ __forceinline__ void unpack16(const uint4& u, float (&x)[4]) {
  x[0] = __uint_as_float(u.x);
  x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z);
  x[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack16(const uint4& u, float (&x)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// ---------------------------------------------------------------------------
// fp32: error-compensated TF32 on m16n8k8
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + O(2^-22 |x|), hi and lo TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// The same split, bit for bit, by full-rate integer and fp32 operations:
// rna_tf32 rounds as cvt.rna does (add half a TF32 ulp to the magnitude's
// bits, clear the 13 dropped bits) without the conversion instruction, of
// which a product-heavy kernel issues two per operand element.
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split_tf32_alu(float x, uint32_t& hi,
                                               uint32_t& lo) {
  hi = rna_tf32(x);
  lo = rna_tf32(x - __uint_as_float(hi));
}

// An operand element as (hi, lo): fp32 split; bf16 exact in TF32, lo = 0.
__device__ __forceinline__ void split_in(float x, uint32_t& hi, uint32_t& lo) {
  split_tf32(x, hi, lo);
}
__device__ __forceinline__ void split_in(__nv_bfloat16 x, uint32_t& hi,
                                         uint32_t& lo) {
  hi = __float_as_uint(__bfloat162float(x));
  lo = 0u;
}

// split_in by split_tf32_alu
__device__ __forceinline__ void split_in_alu(float x, uint32_t& hi,
                                             uint32_t& lo) {
  split_tf32_alu(x, hi, lo);
}
__device__ __forceinline__ void split_in_alu(__nv_bfloat16 x, uint32_t& hi,
                                             uint32_t& lo) {
  split_in(x, hi, lo);
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[j] += A B_j for j < N: hi hi, plus lo hi where A has a low part and
// hi lo where B has one, issued a pass over the j at a time (lo hi, hi lo,
// hi hi): the same order into each accumulator, independent MMAs back to
// back.
template <int N, bool A_LO = true, bool B_LO = true>
__device__ __forceinline__ void mma_passes(float (&c)[N][4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[N][2],
                                           const uint32_t (&bl)[N][2]) {
  if (A_LO) {
#pragma unroll
    for (int j = 0; j < N; ++j) mma_tf32(c[j], al, bh[j][0], bh[j][1]);
  }
  if (B_LO) {
#pragma unroll
    for (int j = 0; j < N; ++j) mma_tf32(c[j], ah, bl[j][0], bl[j][1]);
  }
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(c[j], ah, bh[j][0], bh[j][1]);
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
}

// acc += part in round-to-nearest fp32.  Each tile's product is taken in a
// fresh accumulator and added here: the tensor cores truncate their sums,
// and a truncation bias carried over every tile of a loop grows with its
// length.
template <int NT>
__device__ __forceinline__ void add_to(float (&acc)[NT][4],
                                       const float (&part)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
}

// ---------------------------------------------------------------------------
// bf16: m16n8k16
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x0, x1) = hi + lo + O(2^-17): hi the nearest bf16 pair, lo the nearest
// bf16 pair of the remainder; x0 in the low half (the lower column)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

}  // namespace
