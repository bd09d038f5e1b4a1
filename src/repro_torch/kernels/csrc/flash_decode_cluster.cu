// flash_decode, bf16 split-KV over a thread-block cluster: one-token GQA
// attention against a per-row KV cache, for head dims 64, 128, 160
// (stablelm-12b's) and 256 (recurrentgemma-2b's local-attention ring
// decode: MQA, 10 heads on one KV head).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py
// (flash_decode, pallas_call at :91) for those calls; f32 calls and other
// head dims stay on the tile kernel in flash_decode.cu. kernels/ops.py
// routes each call (ops._decode_kernel) and picks the split
// (ops._decode_splits) before the launch.
//
// What bounds it on an H100: latency, not bytes or operations. At the
// serving shape (q (8,32,128), caches (8,160,8,128), bf16) the call moves
// 2.85 MB (0.85 us at 3.35 TB/s) for 10.9 MFLOP. The tile kernel ran one
// block per (row, KV head), 64 blocks on 132 SMs, each walking up to five
// dependent 32-key tiles, each a device-memory round trip and two block
// barriers.
//
// Design:
// - The positions 0..min(cur[b], T-1) of each (row, KV head) are cut into
//   `splits` slices of `chunk` positions (whole 64-key tiles), one block
//   each; the blocks of a (row, KV head) form one cluster
//   (cudaLaunchKernelEx with a cluster dimension, at most 8). Each block
//   shares every K/V tile of its slice across the group's G <= 16 query
//   rows.
// - Tiles move as bf16 with 16-byte cp.async copies into a two-stage ring
//   (the next tile in flight while this one is used); rows past the
//   slice's last valid position are zero-filled without a read. Rows are
//   padded by 16 bytes, so ldmatrix reads them without bank conflicts.
// - Both products run on the tensor cores (mma.sync m16n8k16, bf16 in,
//   f32 accumulate, as the TPU kernel's dot_generals): the group's rows,
//   zero-padded to 16, are the A operand, held in registers for the whole
//   walk. Every warp computes the tile's full 16 x 64 score block, so the
//   online softmax stays inside the warp (quad shuffles; masked keys score
//   -1e30, never -inf) and p, rounded to bf16 as the TPU kernel casts p to
//   v's dtype, is the A operand of P.V straight from the score registers;
//   each warp then owns a quarter of the head dims of P.V. Two block
//   barriers a tile.
// - Each block pushes its (m, l, acc) for row g into the shared memory of
//   the cluster's block g % splits (distributed shared memory stores,
//   map_shared_rank, once a barrier arrived at on entry shows every peer
//   has started); after one cluster.sync() each block merges its own
//   rows from local shared memory: M = max m, w = exp(m - M),
//   o = sum(w acc) / max(sum(w l), 1e-30), and, when lse is not null, the
//   row's log-sum-exp M + log(sum(w l)), by which a cache split over ranks
//   combines the ranks' partial outputs. No global scratch, no atomics,
//   one launch.
// - A block whose slice lies wholly past cur[b] still reaches the cluster
//   barriers (no early return) and pushes m = -1e30, l = 0, acc = 0, which
//   merges to weight 0. cur[b] >= T attends the whole cache.
// - Head dim 256: the same code at D = 256. Shared memory is ~156 KB
//   (a K and a V stage of 64 x 264 bf16 each twice, 24 pushed f32 rows of
//   256), so one block an SM, above 48 KB only as dynamic shared memory
//   (cudaFuncSetAttribute below). The Q operand held for the walk doubles
//   to 16 k-steps (64 registers) and each warp's quarter of P.V to 64
//   dims (32 accumulators). At recurrentgemma's decode (B = 4, one KV
//   head, T = 2,048) the grid is 4 clusters of 8: 32 blocks on 132 SMs.
// - Head dim 160: ~101 KB of shared memory; each warp's quarter of P.V is
//   40 dims, five 8-dim n-tiles: two ldmatrix.x4.trans pairs and an
//   ldmatrix.x2.trans for the odd fifth tile (both key halves of one
//   n-tile), so no read passes the warp's dims.
// Tried and not kept (PERF.md): f32 products on the CUDA cores,
// one key a thread for the scores and two dims a thread for P.V, with
// scores and p through shared memory: 12.26 us at the serving shape on an
// H100 (tools/kernel_ab.py), the tile phase bound by shared-memory and
// FMA instructions; and peers' statistics read back through distributed
// shared memory after a first cluster barrier, which cost a second
// barrier and a round trip of remote loads.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {
namespace fd_cluster {

namespace cg = cooperative_groups;

constexpr int kThreads = 128;   // four warps
constexpr int kTile = 64;       // keys a tile
constexpr int kStages = 2;      // K/V ring
constexpr int kMaxGroup = 16;   // ops._MAX_GROUP: the mma's 16 rows
constexpr int kMaxSplits = 8;   // the portable cluster size
constexpr int kMaxRecv = kMaxGroup + kMaxSplits;  // >= splits * ceil(G / splits)
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

template <int D>
struct Smem {
  float ml[2][kMaxRecv];      // pushed m and l: [slot]
  float recv[kMaxRecv][D];    // pushed acc: [slot][dim]
  __nv_bfloat16 k[kStages][kTile][D + 8];  // +16 bytes a row: conflict-free ldmatrix
  __nv_bfloat16 v[kStages][kTile][D + 8];
};

// split cluster barrier: arrive at entry, wait before the first access to
// a peer's shared memory (which must have started), so the wait costs
// nothing after the tile walk
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src, or 16 zero bytes without a read when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {  // all but the newest group
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// two 8 x 8 blocks, transposed: lanes 0-7 and 8-15 give their rows
__device__ __forceinline__ void ldsm_x2_trans(uint32_t addr, uint32_t (&r)[2]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// the tile's 64 rows from position t0 of one KV head (kb/vb: position 0,
// row_stride elements between positions) into ring stage `st`; rows at
// or past n are zero-filled
template <int D>
__device__ __forceinline__ void load_tile(Smem<D>& sm, int st, const __nv_bfloat16* kb,
                                          const __nv_bfloat16* vb, long long row_stride, int t0,
                                          int n) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int j = i / kChunks;
    const int c = (i % kChunks) * 8;
    const long long off = j < n ? (long long)(t0 + j) * row_stride + c : 0;
    cp_async16(&sm.k[st][j][c], kb + off, j < n);
    cp_async16(&sm.v[st][j][c], vb + off, j < n);
  }
}

// the kernel's body: grid (splits, K, B), cluster (splits, 1, 1), 128 threads
template <int D>
__device__ __forceinline__ void fd_cluster_body(const __nv_bfloat16* __restrict__ q,
                                                const __nv_bfloat16* __restrict__ k,
                                                const __nv_bfloat16* __restrict__ v,
                                                const int* __restrict__ cur,
                                                __nv_bfloat16* __restrict__ o,
                                                float* __restrict__ lse, int t_len,
                                                int n_heads, int n_kv_heads, int chunk,
                                                float scale) {
  constexpr int kKSteps = D / 16;      // k-steps of Q K^T
  constexpr int kDimTiles = D / 32;    // 8-dim n-tiles of P.V a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();  // this block has started

  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = n_heads / n_kv_heads;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;  // mma fragment row, column pair

  const int limit = min(cur[b], t_len - 1);
  const int t_begin = blockIdx.x * chunk;
  const int last = min(limit, min(t_begin + chunk, t_len) - 1);
  const int n_tiles = last >= t_begin ? (last - t_begin) / kTile + 1 : 0;

  const long long row_stride = (long long)n_kv_heads * D;
  const __nv_bfloat16* kb = k + ((long long)b * t_len * n_kv_heads + kvh) * D;
  const __nv_bfloat16* vb = v + ((long long)b * t_len * n_kv_heads + kvh) * D;
  const __nv_bfloat16* qb = q + ((long long)b * n_heads + (long long)kvh * group) * D;

  if (n_tiles > 0) load_tile(sm, 0, kb, vb, row_stride, t_begin, last - t_begin + 1);
  cp_async_commit();

  // the group's rows as the A operand: rows gid and gid + 8, zero past G
  uint32_t qa[kKSteps][4];
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks) {
    const int d0 = ks * 16 + 2 * tig;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // columns d0, d0 + 8
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // rows gid, gid + 8
        const int g = gid + 8 * r;
        qa[ks][2 * h + r] =
            (n_tiles > 0 && g < group)
                ? *reinterpret_cast<const uint32_t*>(qb + (long long)g * D + d0 + 8 * h)
                : 0u;
      }
    }
  }

  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};  // rows gid, gid + 8
  float acc[kDimTiles][4];
#pragma unroll
  for (int i = 0; i < kDimTiles; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const int d_warp = warp * (D / 4);  // this warp's P.V dims

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages;
    const int t0 = t_begin + it * kTile;
    const int n = min(kTile, last - t0 + 1);
    if (it + 1 < n_tiles) {
      const int t1 = t0 + kTile;
      load_tile(sm, (it + 1) % kStages, kb, vb, row_stride, t1, last - t1 + 1);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();

    // S = Q K^T: 8 n-tiles of 8 keys; ldmatrix of four 8 x 8 blocks gives
    // the B fragments of two k-steps
    float sc[kTile / 8][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kKSteps; ks += 2) {
        uint32_t kf[4];
        ldsm_x4(saddr(&sm.k[st][nt * 8 + (lane & 7)][ks * 16 + (lane >> 3) * 8]), kf);
        mma_bf16(sc[nt], qa[ks], kf[0], kf[1]);
        mma_bf16(sc[nt], qa[ks + 1], kf[2], kf[3]);
      }
    }

    // online softmax over the tile's keys, rows gid (e = 0, 1) and gid + 8
    // (e = 2, 3); key nt * 8 + 2 * tig + (e & 1)
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = nt * 8 + 2 * tig + (e & 1);
        sc[nt][e] = j < n ? sc[nt][e] * scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
      }
    }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_r[r], quad_max(mx[r]));
      corr[r] = expf(m_r[r] - m_new);
      m_r[r] = m_new;
    }
    uint32_t pa[kTile / 16][4];  // p as bf16 A fragments, one per 16 keys
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = expf(sc[nt][e] - m_r[e >> 1]);
        sum[e >> 1] += p[e];
      }
      pa[nt / 2][2 * (nt & 1)] = pack_bf16(p[0], p[1]);      // p cast to v's dtype
      pa[nt / 2][2 * (nt & 1) + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * corr[r] + quad_sum(sum[r]);

    // acc = acc * corr + P V over this warp's dims; ldmatrix.trans of V
    // gives the B fragments of two dim tiles (of one for an odd last tile)
#pragma unroll
    for (int dt = 0; dt < kDimTiles; ++dt) {
      acc[dt][0] *= corr[0];
      acc[dt][1] *= corr[0];
      acc[dt][2] *= corr[1];
      acc[dt][3] *= corr[1];
    }
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
#pragma unroll
      for (int dt = 0; dt + 1 < kDimTiles; dt += 2) {
        uint32_t vf[4];
        const int mi = lane >> 3;
        ldsm_x4_trans(saddr(&sm.v[st][kk * 16 + (mi & 1) * 8 + (lane & 7)]
                                 [d_warp + (dt + (mi >> 1)) * 8]),
                      vf);
        mma_bf16(acc[dt], pa[kk], vf[0], vf[1]);
        mma_bf16(acc[dt + 1], pa[kk], vf[2], vf[3]);
      }
      if constexpr (kDimTiles % 2 == 1) {
        constexpr int dt = kDimTiles - 1;
        uint32_t vf[2];
        ldsm_x2_trans(saddr(&sm.v[st][kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)]
                                 [d_warp + dt * 8]),
                      vf);
        mma_bf16(acc[dt], pa[kk], vf[0], vf[1]);
      }
    }
    __syncthreads();  // the stage is free for the tile after next
  }

  // push (m, l, acc) of each row g < G to block g % splits, slot
  // rank * per + g / splits
  const int splits = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int per = (group + splits - 1) / splits;
  cluster_wait();  // every peer has started
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int g = gid + 8 * r;
    if (g < group) {
      Smem<D>* dst = cluster.map_shared_rank(&sm, g % splits);
      const int slot = rank * per + g / splits;
#pragma unroll
      for (int dt = 0; dt < kDimTiles; ++dt)
        *reinterpret_cast<float2*>(&dst->recv[slot][d_warp + dt * 8 + 2 * tig]) =
            make_float2(acc[dt][2 * r], acc[dt][2 * r + 1]);
      if (warp == 0 && tig == 0) {
        dst->ml[0][slot] = m_r[r];
        dst->ml[1][slot] = l_r[r];
      }
    }
  }
  cluster.sync();

  // merge this block's rows rank, rank + splits, ... from local shared memory
  __nv_bfloat16* ob = o + ((long long)b * n_heads + (long long)kvh * group) * D;
  for (int i = tid; i < per * D; i += kThreads) {
    const int row = i / D, d = i % D;
    const int g = rank + splits * row;
    if (g >= group) continue;
    float mx = kNegInf;
    for (int src = 0; src < splits; ++src) mx = fmaxf(mx, sm.ml[0][src * per + row]);
    float l = 0.f, a = 0.f;
    for (int src = 0; src < splits; ++src) {
      const int slot = src * per + row;
      const float w = expf(sm.ml[0][slot] - mx);
      l = fmaf(sm.ml[1][slot], w, l);
      a = fmaf(sm.recv[slot][d], w, a);
    }
    ob[(long long)g * D + d] = __float2bfloat16(a / fmaxf(l, 1e-30f));
  }
  // each row's log-sum-exp in a loop of its own: written from the merge
  // loop above, it made ptxas spill at D = 256
  if (lse != nullptr) {
    for (int row = tid; row < per; row += kThreads) {
      const int g = rank + splits * row;
      if (g >= group) continue;
      float mx = kNegInf;
      for (int src = 0; src < splits; ++src) mx = fmaxf(mx, sm.ml[0][src * per + row]);
      float l = 0.f;
      for (int src = 0; src < splits; ++src)
        l = fmaf(sm.ml[1][src * per + row], expf(sm.ml[0][src * per + row] - mx), l);
      lse[(long long)b * n_heads + (long long)kvh * group + g] = mx + logf(fmaxf(l, 1e-30f));
    }
  }
}

#define FD_CLUSTER_PARAMS                                                                       \
  const __nv_bfloat16 *__restrict__ q, const __nv_bfloat16 *__restrict__ k,                    \
      const __nv_bfloat16 *__restrict__ v, const int *__restrict__ cur,                        \
      __nv_bfloat16 *__restrict__ o, float *__restrict__ lse, int t_len, int n_heads,          \
      int n_kv_heads, int chunk, float scale

// head dims 64, 128 and 256
template <int D>
__global__ void __launch_bounds__(kThreads) fd_cluster_kernel(FD_CLUSTER_PARAMS) {
  fd_cluster_body<D>(q, k, v, cur, o, lse, t_len, n_heads, n_kv_heads, chunk, scale);
}

// head dim 160: under the default bounds ptxas holds this instantiation to
// 128 registers and spills; at one block an SM it keeps all in registers
// (~200). Its ~101 KB of shared memory allows two blocks an SM at most.
template <int D>
__global__ void __launch_bounds__(kThreads, 1) fd_cluster_kernel_1sm(FD_CLUSTER_PARAMS) {
  fd_cluster_body<D>(q, k, v, cur, o, lse, t_len, n_heads, n_kv_heads, chunk, scale);
}
#undef FD_CLUSTER_PARAMS

template <int D>
constexpr auto cluster_kernel() {  // instantiates only the kernel D runs
  if constexpr (D == 160) {
    return fd_cluster_kernel_1sm<D>;
  } else {
    return fd_cluster_kernel<D>;
  }
}

template <int D>
static int launch(const void* q, const void* k, const void* v, const int* cur, void* o,
                  float* lse, int b, int t_len, int n_heads, int n_kv_heads, int splits,
                  int chunk, cudaStream_t stream) {
  const auto kernel = cluster_kernel<D>();
  const int smem = (int)sizeof(Smem<D>);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)splits, (unsigned)n_kv_heads, (unsigned)b);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float scale = 1.f / sqrtf((float)D);
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const __nv_bfloat16*>(q),
                           static_cast<const __nv_bfloat16*>(k),
                           static_cast<const __nv_bfloat16*>(v), cur,
                           static_cast<__nv_bfloat16*>(o), lse, t_len, n_heads, n_kv_heads,
                           chunk, scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace fd_cluster
}  // namespace repro_torch

// q (B,H,D), k/v caches (B,T,K,D), cur (B,) int32, o (B,H,D), all
// contiguous bf16 and 16-byte aligned; lse (B,H) f32 or null; D 64, 128,
// 160 or 256; H / K <= 16;
// 1 <= splits <= 8 slices of chunk positions (a multiple of 64) covering T.
// Returns the launch's error, else cudaGetLastError().
extern "C" int repro_torch_flash_decode_cluster(const void* q, const void* k, const void* v,
                                                const void* cur, void* o, void* lse, int b,
                                                int t_len, int n_heads, int n_kv_heads,
                                                int d_head, int splits, int chunk,
                                                void* stream) {
  using namespace repro_torch::fd_cluster;
  if (n_kv_heads < 1 || n_heads % n_kv_heads || n_heads / n_kv_heads > kMaxGroup ||
      splits < 1 || splits > kMaxSplits || chunk < 1 || chunk % kTile ||
      (long long)splits * chunk < t_len)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const int* c = static_cast<const int*>(cur);
  float* l = static_cast<float*>(lse);
  if (d_head == 64)
    return launch<64>(q, k, v, c, o, l, b, t_len, n_heads, n_kv_heads, splits, chunk, st);
  if (d_head == 128)
    return launch<128>(q, k, v, c, o, l, b, t_len, n_heads, n_kv_heads, splits, chunk, st);
  if (d_head == 160)
    return launch<160>(q, k, v, c, o, l, b, t_len, n_heads, n_kv_heads, splits, chunk, st);
  if (d_head == 256)
    return launch<256>(q, k, v, c, o, l, b, t_len, n_heads, n_kv_heads, splits, chunk, st);
  return (int)cudaErrorInvalidValue;
}
