// Split-KV flash-decode for Hopper (sm_90a), dense and paged, plain C
// interface: one launch a call, the split-KV merge inside a thread-block
// cluster.
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
// multiply-adds, so with G = 1 (gpt2, zamba2) a kernel does ~0.5 operation
// per byte and the least time is 2 * sum(lengths) * KV * D * elt bytes over
// 3.35 TB/s: a few microseconds on the serving paths, where fixed costs
// (launches, latency, a second pass) set the time.  So:
//   * One launch.  A cluster of C blocks (C <= 8, the portable maximum)
//     serves one (slot, kv head) cell; block r takes keys [r R, (r+1) R) of
//     the slot's valid ones, R = ceil(len / C) rounded up to the key tile,
//     so a short slot leaves no block walking dead keys.  C is the most
//     that keeps the grid in one wave of at most 4 blocks an SM.  Each
//     block keeps its partial (o, m, l) in shared memory (a block with no
//     keys keeps (0, -1e30, 0)) and stores slice s of it through
//     distributed shared memory into block s; after one cluster barrier
//     each block merges its slice of G x D in rank order with the rule of
//     src/repro/kernels/flash_decode/ops.py:60-61 (gm = max m; o = sum o
//     exp(m - gm); l = sum l exp(m - gm)) and writes it.  No global
//     scratch, no atomics: two runs give the same bits.
//   * K and V stream together.  A block walks its range in tiles of TILE
//     keys through a ring of cp.async stages, each stage holding the
//     tile's K rows and V rows, both requested at once; every global load
//     is 16 bytes (4 fp32 or 8 bf16 elements; D x elt is a multiple of 16
//     for D = 64, 80, 128), and a row past the range or unowned is
//     zero-filled without being read.
//   * The score work is cheap to reduce.  A key belongs to LPK lanes (4, or
//     8 at D = 128) that each hold a slice of its row and of q, so its dot
//     product reduces in log2(LPK) shuffles; the same lanes fold that key
//     into a running (m, l, o slice) of their own (the online softmax over
//     tiles, every exponent a difference <= 0).  The 32 / LPK key groups of
//     a warp merge once at the end by shuffles, the warps in shared memory,
//     then the cluster.  Where G > 1 the warps also split the query rows.
//   * The paged kernel addresses each key once: the block stages the page
//     ids its range spans (none at or past ceil(len / ps)), and one tile
//     ahead of the loads one thread a key turns the key's page and offset
//     (a multiply-high and shift, not a division) into k and v row offsets
//     stored beside the tile, so the K and V loads issue from a ready
//     address.  An unowned key inside the slot's length counts as a zero
//     key and value, as in the plain version (the reference's oracle,
//     `gather_pages`, zeroes unowned pages); the TPU kernel skips such a
//     page instead.  The two agree on every row whose unowned entries lie
//     at or past its length, which is every live row of the engine; its
//     inactive rows (length 1, no page) give (0, 0, 1) here and
//     (0, -1e30, 0) on the TPU, and nobody reads them.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <cmath>

#include "sm90_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int TILE = 32;          // keys a pipeline stage holds
constexpr int MAX_CLUSTER = 8;    // the portable cluster size
constexpr float NEG_INF = -1e30f;

__host__ __device__ constexpr int gcd(int a, int b) {
  return b == 0 ? a : gcd(b, a % b);
}
__host__ __device__ constexpr int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

// The layout of one instance: element type T, head dim D, group size G.
template <typename T, int D, int G>
struct Shape {
  static constexpr int VEC = 16 / sizeof(T);   // elements a 16-byte chunk
  static constexpr int NC = D / VEC;           // chunks a row
  static constexpr int LPK = D == 128 ? 8 : 4; // lanes a key
  static constexpr int CPL = ceil_div(NC, LPK);  // chunks a lane (at most)
  static constexpr bool EVEN = NC % LPK == 0;  // every lane CPL chunks
  static constexpr int E = CPL * VEC;          // elements a lane
  static constexpr int KPW = 32 / LPK;         // key groups a warp
  static constexpr int WG = gcd(G, WARPS);     // warps across query rows
  static constexpr int RPW = G / WG;           // query rows a warp
  static constexpr int WK = WARPS / WG;        // warps across keys
  static constexpr int KPG = TILE / (WK * KPW);  // keys a key group a tile
  // A tile's rows in shared memory, RSC chunks apart.  A quarter warp's
  // 16-byte loads read 8 chunks: LPK = 8 reads 8 chunks of one row; LPK =
  // 4 reads 4 of each of two neighbouring rows, which XOR chunk c of an
  // odd row with 4 where NC % 8 == 0 and otherwise start RSC = 4 (mod 8)
  // chunks apart (D = 80), so the 8 fall in distinct banks.
  static constexpr bool SWIZZLE = LPK == 4 && NC % 8 == 0;
  static constexpr int RSC =
      (LPK == 8 || SWIZZLE) ? NC : NC + ((4 - NC % 8) + 8) % 8;
  static constexpr int TILE_CHUNKS = TILE * RSC;
  static constexpr int STAGE_BYTES = 2 * TILE_CHUNKS * 16;  // K and V
  static constexpr int STAGES = STAGE_BYTES <= 16384 ? 3 : 2;
  static constexpr int NOFF = STAGES + 1;      // paged: row-offset slots
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  static constexpr int OFF_BYTES = NOFF * TILE * 2 * 8;
  // after the key loop the ring holds the warps' partials and the block's
  static constexpr int PART_FLOATS = (WK + (WK > 1)) * G * (D + 2);
  static_assert(NC * VEC == D && KPG >= 1 && KPG * WK * KPW == TILE,
                "layout");
  static_assert(PART_FLOATS * 4 <= RING_BYTES, "partials fit the ring");
  __device__ static int phys(int j, int c) {
    return j * RSC + (SWIZZLE ? c ^ ((j & 1) << 2) : c);
  }
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  const int* table;  // paged: (B, max_pages) int32, -1 = unowned
  float* o;
  float* m;
  float* l;
  int s;             // keys a slot can hold: S, or max_pages * page_size
  int kvh;
  int max_pages, ps;           // paged
  uint32_t ps_mul;             // paged: col / ps = umulhi(col, ps_mul) >>
  int ps_shift;                //   ps_shift (ps > 1)
  int max_ids;                 // paged: page ids a block stages, at most
  // element strides: dense (slot, position, head), paged (page, offset,
  // head)
  int64_t k_s0, k_s1, k_sh, v_s0, v_s1, v_sh;
  float scale;
};

template <typename T, int D, int G, bool PAGED>
__global__ void __launch_bounds__(THREADS) decode_kernel(const Args a) {
  using S = Shape<T, D, G>;
  constexpr int VEC = S::VEC, NC = S::NC, LPK = S::LPK, CPL = S::CPL,
                E = S::E, RPW = S::RPW, KPG = S::KPG, STAGES = S::STAGES;
  extern __shared__ float4 smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  cluster_arrive_relaxed();  // this block runs (waited for before the merge)
  const int h = blockIdx.y, b = blockIdx.z;
  const int64_t cell = (int64_t)b * a.kvh + h;  // (slot, kv head)

  // this block's keys [start, end) of the slot's valid ones
  const int len = max(0, min(a.lengths[b], a.s));
  const int per = ceil_div(ceil_div(len, csize), TILE) * TILE;
  const int start = min(len, rank * per);
  const int end = min(len, start + per);
  const int n = end - start;
  const int nt = ceil_div(n, TILE);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gw = warp % S::WG, wk = warp / S::WG;
  const int kg = lane / LPK, part = lane % LPK;

  // q rows gw * RPW + r, this lane's chunks part + LPK i, in fp32
  float qr[RPW][E];
  {
    const T* qp = static_cast<const T*>(a.q) + (cell * G + gw * RPW) * D;
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int c = part + LPK * i;
        float x[VEC];
        if (S::EVEN || c < NC) {
          unpack16(*reinterpret_cast<const uint4*>(qp + r * D + c * VEC), x);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) x[e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) qr[r][i * VEC + e] = x[e];
      }
  }

  float4* ring = smem;
  int64_t* offs =
      reinterpret_cast<int64_t*>(smem + STAGES * 2 * S::TILE_CHUNKS);
  int* ids = reinterpret_cast<int*>(offs + S::NOFF * TILE * 2);
  const T* kb = static_cast<const T*>(a.k) + h * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + h * a.v_sh;
  if (!PAGED) {
    kb += b * a.k_s0;
    vb += b * a.v_s0;
  }
  int page0 = 0;
  if (PAGED && n > 0) {
    // the page ids of logical pages page0 .. (end - 1) / ps, all below
    // ceil(len / ps): no table entry past the length is read
    page0 = start / a.ps;
    const int n_ids = (end - 1) / a.ps - page0 + 1;
    for (int i = threadIdx.x; i < n_ids; i += THREADS)
      ids[i] = a.table[(int64_t)b * a.max_pages + page0 + i];
    __syncthreads();
  }

  // paged: the k and v row offsets of tile t's keys (-1: unowned or past
  // the range), one thread a key
  const auto stage_offsets = [&](int t) {
    int64_t* o2 = offs + (t % S::NOFF) * TILE * 2;
    for (int j = threadIdx.x; j < TILE; j += THREADS) {
      const int col = start + t * TILE + j;
      int64_t ko = -1, vo = -1;
      if (col < end) {
        const int page =
            a.ps == 1 ? col : (int)(__umulhi((uint32_t)col, a.ps_mul) >>
                                    a.ps_shift);
        const int off = col - page * a.ps;
        const int id = ids[page - page0];
        if (id >= 0) {
          ko = id * a.k_s0 + off * a.k_s1;
          vo = id * a.v_s0 + off * a.v_s1;
        }
      }
      o2[2 * j] = ko;
      o2[2 * j + 1] = vo;
    }
  };
  // tile t's K and V rows into stage t % STAGES, zero-filled past the
  // range and where unowned (nothing read)
  const auto load = [&](int t) {
    float4* ks = ring + (t % STAGES) * 2 * S::TILE_CHUNKS;
    float4* vs = ks + S::TILE_CHUNKS;
    const int64_t* o2 = offs + (t % S::NOFF) * TILE * 2;
    for (int idx = threadIdx.x; idx < TILE * NC; idx += THREADS) {
      const int j = idx / NC, c = idx % NC;
      const int col = start + t * TILE + j;
      const T* kr = kb;
      const T* vr = vb;
      bool ok;
      if (PAGED) {
        const int64_t ko = o2[2 * j];
        ok = ko >= 0;
        if (ok) {
          kr = kb + ko;
          vr = vb + o2[2 * j + 1];
        }
      } else {
        ok = col < end;
        if (ok) {
          kr = kb + col * a.k_s1;
          vr = vb + col * a.v_s1;
        }
      }
      const int p = S::phys(j, c);
      cp_async16(ks + p, kr + (ok ? c * VEC : 0), ok);
      cp_async16(vs + p, vr + (ok ? c * VEC : 0), ok);
    }
  };

  // this key group's running softmax over its keys: m, l and the lane's
  // slice of o, for the warp's query rows
  float m[RPW], l[RPW], acc[RPW][E];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  }

  const auto compute = [&](int t) {
    const float4* ks = ring + (t % STAGES) * 2 * S::TILE_CHUNKS;
    const float4* vs = ks + S::TILE_CHUNKS;
    const int valid = min(TILE, n - t * TILE);
    float p[KPG][RPW];
    // scores s = (q . k) * scale of this key group's keys
#pragma unroll
    for (int kk = 0; kk < KPG; ++kk) {
      const int j = (kk * S::WK + wk) * S::KPW + kg;
#pragma unroll
      for (int r = 0; r < RPW; ++r) p[kk][r] = 0.f;
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int c = part + LPK * i;
        if (S::EVEN || c < NC) {
          float x[VEC];
          unpack16(*reinterpret_cast<const uint4*>(ks + S::phys(j, c)), x);
#pragma unroll
          for (int r = 0; r < RPW; ++r)
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              p[kk][r] = fmaf(qr[r][i * VEC + e], x[e], p[kk][r]);
        }
      }
#pragma unroll
      for (int off = LPK / 2; off > 0; off >>= 1)
#pragma unroll
        for (int r = 0; r < RPW; ++r)
          p[kk][r] += __shfl_xor_sync(0xffffffffu, p[kk][r], off);
#pragma unroll
      for (int r = 0; r < RPW; ++r) p[kk][r] *= a.scale;
    }
    // online softmax: rescale by exp(m_old - m_new) (1 where m did not
    // rise), then p = exp(s - m_new); keys past the range give p = 0
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      float mx = m[r];
#pragma unroll
      for (int kk = 0; kk < KPG; ++kk)
        if ((kk * S::WK + wk) * S::KPW + kg < valid)
          mx = max_nan(mx, p[kk][r]);
      const float corr = expf(m[r] - mx);
      m[r] = mx;
      l[r] *= corr;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] *= corr;
#pragma unroll
      for (int kk = 0; kk < KPG; ++kk) {
        const bool in = (kk * S::WK + wk) * S::KPW + kg < valid;
        p[kk][r] = in ? expf(p[kk][r] - mx) : 0.f;
        l[r] += p[kk][r];
      }
    }
    // o += p v
#pragma unroll
    for (int kk = 0; kk < KPG; ++kk) {
      const int j = (kk * S::WK + wk) * S::KPW + kg;
      if (j < valid) {
#pragma unroll
        for (int i = 0; i < CPL; ++i) {
          const int c = part + LPK * i;
          if (S::EVEN || c < NC) {
            float x[VEC];
            unpack16(*reinterpret_cast<const uint4*>(vs + S::phys(j, c)), x);
#pragma unroll
            for (int r = 0; r < RPW; ++r)
#pragma unroll
              for (int e = 0; e < VEC; ++e)
                acc[r][i * VEC + e] =
                    fmaf(p[kk][r], x[e], acc[r][i * VEC + e]);
          }
        }
      }
    }
  };

  // the key loop: STAGES - 1 tiles in flight ahead of the one computed
  if (PAGED) {
#pragma unroll
    for (int t = 0; t < STAGES - 1; ++t)
      if (t < nt) stage_offsets(t);
    __syncthreads();
  }
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < nt) load(t);
    cp_commit();
  }
  if (PAGED && STAGES - 1 < nt) stage_offsets(STAGES - 1);
  for (int t = 0; t < nt; ++t) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // tile t landed for all; stage (t - 1) free
    if (t + STAGES - 1 < nt) load(t + STAGES - 1);
    cp_commit();
    if (PAGED && t + STAGES < nt) stage_offsets(t + STAGES);
    compute(t);
  }
  cp_wait<0>();

  // merge the warp's key groups (lanes part, part + LPK, ...) by shuffles
#pragma unroll
  for (int off = LPK; off < 32; off <<= 1)
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], off);
      const float mx = max_nan(m[r], mo);
      const float ca = expf(m[r] - mx), cb = expf(mo - mx);
      l[r] = l[r] * ca + lo * cb;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[r][e], off);
        acc[r][e] = acc[r][e] * ca + ao * cb;
      }
      m[r] = mx;
    }
  __syncthreads();  // every warp done with the ring

  // the warps' partials, then the block's (the ring is free now)
  constexpr int GD = G * D, WK = S::WK;
  float* o_w = reinterpret_cast<float*>(smem);  // (WK, G, D)
  float* m_w = o_w + WK * GD;                   // (WK, G)
  float* l_w = m_w + WK * G;
  float* o_b = WK > 1 ? l_w + WK * G : o_w;     // (G, D)
  float* m_b = WK > 1 ? o_b + GD : m_w;
  float* l_b = WK > 1 ? m_b + G : l_w;
  if (kg == 0) {
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int g = gw * RPW + r;
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int c = part + LPK * i;
        if (S::EVEN || c < NC) {
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            o_w[(wk * G + g) * D + c * VEC + e] = acc[r][i * VEC + e];
        }
      }
      if (part == 0) {
        m_w[wk * G + g] = m[r];
        l_w[wk * G + g] = l[r];
      }
    }
  }
  if (WK > 1) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < GD + G; idx += THREADS) {
      const int g = idx < GD ? idx / D : idx - GD;
      float gm = NEG_INF;
#pragma unroll
      for (int w = 0; w < WK; ++w) gm = max_nan(gm, m_w[w * G + g]);
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < WK; ++w)
        sum += (idx < GD ? o_w[w * GD + idx] : l_w[w * G + g]) *
               expf(m_w[w * G + g] - gm);
      if (idx < GD) {
        o_b[idx] = sum;
      } else {
        m_b[g] = gm;
        l_b[g] = sum;
      }
    }
  }
  __syncthreads();  // the block's partial is whole

  // Block s of the cluster merges slice s of o, [s SL, (s + 1) SL); block 0
  // also m and l.  Each block stores its slices, with all of its m and l,
  // into slot `rank` of the owners' gather buffers through distributed
  // shared memory; after one barrier every block reads only its own.
  const int sl = ceil_div(GD, csize), slot = sl + 2 * G;
  float* gather = PAGED ? reinterpret_cast<float*>(ids + a.max_ids)
                        : reinterpret_cast<float*>(offs);  // (C, slot)
  cluster_wait();  // every block of the cluster runs
  for (int idx = threadIdx.x; idx < csize * slot; idx += THREADS) {
    const int s = idx / slot, e = idx - s * slot, i = s * sl + e;
    const float x = e < sl ? (i < GD ? o_b[i] : 0.f)
                           : (e < sl + G ? m_b[e - sl] : l_b[e - sl - G]);
    cluster.map_shared_rank(gather, s)[rank * slot + e] = x;
  }
  cluster.sync();  // every slice in its owner's gather buffer

  // this block's slice, merged in rank order
  for (int e = threadIdx.x; e < sl + (rank == 0 ? G : 0); e += THREADS) {
    const int i = rank * sl + e;
    if (e < sl && i >= GD) continue;
    const int g = e < sl ? i / D : e - sl;
    float mr[MAX_CLUSTER];
    float gm = NEG_INF;
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r) {
      mr[r] = r < csize ? gather[r * slot + sl + g] : NEG_INF;
      gm = max_nan(gm, mr[r]);
    }
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
      if (r < csize)
        sum += gather[r * slot + (e < sl ? e : sl + G + g)] *
               expf(mr[r] - gm);
    if (e < sl) {
      a.o[cell * GD + i] = sum;
    } else {
      a.m[cell * G + g] = gm;
      a.l[cell * G + g] = sum;
    }
  }
}

// At most this many blocks an SM in the one wave a launch aims for: more,
// each with fewer keys, ran no faster on the H100 (PERF.md, PR 19).
constexpr int MAX_BLOCKS_PER_SM = 4;

int sm_count() {
  static std::atomic<int> n{0};
  if (n.load(std::memory_order_relaxed) == 0) {
    int dev = 0, v = 0;
    if (cudaGetDevice(&dev) == cudaSuccess &&
        cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) ==
            cudaSuccess)
      n.store(v, std::memory_order_relaxed);
  }
  return std::max(1, n.load(std::memory_order_relaxed));
}

// Blocks of an instance an SM holds with `bytes` of dynamic shared memory,
// remembered for the last size asked.
template <typename T, int D, int G, bool PAGED>
cudaError_t blocks_per_sm(size_t bytes, int* n) {
  static std::atomic<uint64_t> memo{0};  // bytes << 8 | blocks
  const uint64_t seen = memo.load(std::memory_order_relaxed);
  if (seen >> 8 == bytes) {
    *n = (int)(seen & 0xff);
    return cudaSuccess;
  }
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      n, decode_kernel<T, D, G, PAGED>, THREADS, bytes);
  if (err == cudaSuccess)
    memo.store((uint64_t)bytes << 8 | (uint64_t)std::min(*n, 255),
               std::memory_order_relaxed);
  return err;
}

// Launch in clusters of the most blocks (8, 4, 2 or 1) that keep the grid
// in one wave of at most MAX_BLOCKS_PER_SM blocks an SM and give each block
// at least a tile of a full-length slot.
template <typename T, int D, int G, bool PAGED>
cudaError_t launch(Args a, int b, cudaStream_t st) {
  using S = Shape<T, D, G>;
  constexpr int GD = G * D;
  const auto kernel = decode_kernel<T, D, G, PAGED>;
  // page ids a block stages: its range spans at most ceil(R / ps) + 1 pages
  const auto ids_for = [&](int c) {
    const int per = ceil_div(ceil_div(a.s, c), TILE) * TILE;
    return PAGED ? ceil_div(per, a.ps) + 1 : 0;
  };
  const auto bytes_for = [&](int c) {
    return (size_t)S::RING_BYTES +
           (PAGED ? S::OFF_BYTES + ids_for(c) * sizeof(int) : 0) +
           c * (ceil_div(GD, c) + 2 * G) * sizeof(float);
  };
  size_t most = 0;
  for (int c = 1; c <= MAX_CLUSTER; c *= 2)
    most = std::max(most, bytes_for(c));
  static std::atomic<size_t> allowed{48 * 1024};  // per instance
  if (most > allowed.load(std::memory_order_relaxed)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
    if (err != cudaSuccess) return err;
    allowed.store(most, std::memory_order_relaxed);
  }
  int per_sm = 0;
  const cudaError_t occ = blocks_per_sm<T, D, G, PAGED>(most, &per_sm);
  if (occ != cudaSuccess) return occ;
  const int64_t room =
      (int64_t)sm_count() * std::min(per_sm, MAX_BLOCKS_PER_SM);
  int c = MAX_CLUSTER;
  while (c > 1 && (ceil_div(a.s, c) < TILE || (int64_t)b * a.kvh * c > room))
    c /= 2;
  a.max_ids = ids_for(c);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c, a.kvh, b);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = bytes_for(c);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

template <typename T, int D, bool PAGED>
cudaError_t by_group(int g, const Args& a, int b, cudaStream_t st) {
  switch (g) {
    case 1: return launch<T, D, 1, PAGED>(a, b, st);
    case 2: return launch<T, D, 2, PAGED>(a, b, st);
    case 3: return launch<T, D, 3, PAGED>(a, b, st);
    case 4: return launch<T, D, 4, PAGED>(a, b, st);
    case 6: return launch<T, D, 6, PAGED>(a, b, st);
    case 8: return launch<T, D, 8, PAGED>(a, b, st);
    default: return cudaErrorInvalidValue;
  }
}

template <bool PAGED>
cudaError_t dispatch(int dtype, int d, int g, const Args& a, int b,
                     cudaStream_t st) {
  if (dtype == 0 && d == 64) return by_group<float, 64, PAGED>(g, a, b, st);
  if (dtype == 0 && d == 80) return by_group<float, 80, PAGED>(g, a, b, st);
  if (dtype == 0 && d == 128) return by_group<float, 128, PAGED>(g, a, b, st);
  if (dtype == 1 && d == 64)
    return by_group<__nv_bfloat16, 64, PAGED>(g, a, b, st);
  if (dtype == 1 && d == 80)
    return by_group<__nv_bfloat16, 80, PAGED>(g, a, b, st);
  if (dtype == 1 && d == 128)
    return by_group<__nv_bfloat16, 128, PAGED>(g, a, b, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B, KV, G, D) contiguous; k, v (B, S, KV, D) with unit stride on D and
// element strides (b, s, h) in k_s* / v_s*; lengths (B,) int32.  Outputs o
// (B, KV, G, D), m / l (B, KV, G) fp32.  dtype: 0 = float32, 1 = bfloat16.
// q, k, v 16-byte aligned with strides of 16-byte multiples.  Returns a
// cudaError_t.
extern "C" int flash_decode_fwd(const void* q, const void* k, const void* v,
                                const void* lengths, void* o, void* m,
                                void* l, int b, int s, int kvh, int g, int d,
                                int64_t k_sb, int64_t k_ss, int64_t k_sh,
                                int64_t v_sb, int64_t v_ss, int64_t v_sh,
                                int dtype, void* stream) {
  Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.lengths = static_cast<const int*>(lengths);
  a.o = static_cast<float*>(o);
  a.m = static_cast<float*>(m);
  a.l = static_cast<float*>(l);
  a.s = s;
  a.kvh = kvh;
  a.k_s0 = k_sb;
  a.k_s1 = k_ss;
  a.k_sh = k_sh;
  a.v_s0 = v_sb;
  a.v_s1 = v_ss;
  a.v_sh = v_sh;
  a.scale = 1.f / std::sqrt((float)d);
  return (int)dispatch<false>(dtype, d, g, a, b,
                              static_cast<cudaStream_t>(stream));
}

// q (B, KV, G, D) contiguous; k, v pools (n_pages, page_size, KV, D) with
// unit stride on D and element strides (page, offset, h) in k_s* / v_s*;
// page_table (B, max_pages) int32 contiguous, -1 = unowned, every other
// entry a page id below n_pages; lengths (B,) int32, clamped to
// max_pages * page_size < 2^31.  Outputs and alignment as
// flash_decode_fwd.  Returns a cudaError_t.
extern "C" int flash_decode_paged_fwd(
    const void* q, const void* k, const void* v, const void* page_table,
    const void* lengths, void* o, void* m, void* l, int b, int max_pages,
    int page_size, int kvh, int g, int d, int64_t k_sp, int64_t k_so,
    int64_t k_sh, int64_t v_sp, int64_t v_so, int64_t v_sh, int dtype,
    void* stream) {
  if (page_size < 1) return (int)cudaErrorInvalidValue;
  Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.lengths = static_cast<const int*>(lengths);
  a.table = static_cast<const int*>(page_table);
  a.o = static_cast<float*>(o);
  a.m = static_cast<float*>(m);
  a.l = static_cast<float*>(l);
  a.s = max_pages * page_size;
  a.kvh = kvh;
  a.max_pages = max_pages;
  a.ps = page_size;
  // col / ps for col < 2^31 as umulhi(col, mul) >> shift, mul = ceil(2^p /
  // ps), p = 31 + ceil(log2 ps) (CUTLASS's FastDivmod); ps = 1 is col
  int log2 = 0;
  while ((1 << log2) < page_size) ++log2;
  a.ps_shift = log2 - 1;
  a.ps_mul = page_size == 1 ? 0u : (uint32_t)(((1ull << (31 + log2))
                                               + page_size - 1) / page_size);
  a.k_s0 = k_sp;
  a.k_s1 = k_so;
  a.k_sh = k_sh;
  a.v_s0 = v_sp;
  a.v_s1 = v_so;
  a.v_sh = v_sh;
  a.scale = 1.f / std::sqrt((float)d);
  return (int)dispatch<true>(dtype, d, g, a, b,
                             static_cast<cudaStream_t>(stream));
}
