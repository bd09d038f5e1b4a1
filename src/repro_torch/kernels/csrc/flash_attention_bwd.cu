// flash_attention backward, bf16 on the tensor cores: the gradient of the
// training path's causal GQA attention (q (B,S,H,D), k/v (B,T,K,D)) for
// head dims 64 and 128 and groups H/K that divide 64, from the saved q, k,
// v, the output o and each row's log-sum-exp lse (B,H,S) f32, which the
// training forward (fa_train_fwd_kernel in flash_attention_wgmma.cu)
// writes.
//
// Replaces no TPU kernel: the JAX package's training attention is jnp
// outside any Pallas kernel, and XLA differentiates it. It was added
// because the port's plain version of that path (layers/sdpa.py under
// autograd) writes the f32 scores and their softmax, S x T a head, to
// device memory and reads them in several elementwise passes forward,
// in remat's recompute and backward: at granite-3-8b's 4,096 tokens that
// was about half of a training step. Nothing of S x T leaves the chip
// here.
//
// What bounds it on an H100: operations. At granite-3-8b's training shape
// (q (1,4096,32,128), k/v (1,4096,8,128)) the five causal products (S,
// dP, dV, dK, dQ) are 3.44e11 FLOP, 0.347 ms at the 989 TFLOP/s bf16
// peak, against ~100 MB of q, k, v, o, dO, lse and the three gradients
// (30 us). This design runs S and dP twice (seven products, 4.81e11
// FLOP) to keep dQ free of atomics.
//
// Three kernels, one stream, launched by repro_torch_flash_attention_bwd:
// - fa_bwd_delta_kernel: Delta = rowsum(dO * O) in f32 (B,H,S), one warp a
//   row.
// - fa_bwd_kv_kernel: one block (one warpgroup) per (batch row, KV head,
//   64-key tile). K and V tiles are loaded once; the block walks the
//   query tiles at or past the key tile's diagonal (64 rows each, 64/G
//   positions x the group's G heads, as the forward packs them), Q and dO
//   through a two-slot TMA ring, and keeps dK and dV of its keys for the
//   whole group in f32 registers: no atomics. Per query tile, on wgmma:
//   S^T = K Q^T and dP^T = V dO^T (A and B from shared memory, K-major),
//   P^T = exp2(S^T scale log2e - lse log2e) in f32 (each column's lse and
//   Delta staged in shared memory a tile ahead), dS^T = P^T (dP^T - Delta)
//   scale; then dV += P^T dO and dK += dS^T Q with P^T and dS^T rounded to
//   bf16 straight from the accumulator fragment into A fragments, dO and
//   Q as MN-major B (the forward's P V form). Computing S^T rather than S
//   is what puts the keys on the wgmma's M, so P^T needs no trip through
//   shared memory.
// - fa_bwd_dq_kernel: one block per (batch row, KV head, 64-row query
//   tile), K and V through the ring, key tiles up to the tile's diagonal:
//   S = Q K^T and dP = dO V^T again, dS as above, dQ += dS K (dS from
//   registers, K MN-major). dQ is written once, in bf16, by the block
//   that owns its rows: the gradient is deterministic (bit-equal from run
//   to run). Chosen by measurement over the alternative, dQ added into an
//   f32 scratch with atomics by fa_bwd_kv_kernel, which saves the two
//   recomputed products: at granite-3-8b's training shape on an H100
//   80GB HBM3 the whole backward took 1.09 ms this way and 3.41 ms with
//   the atomics (8,192 f32 adds a tile pair), whose sum's order, and so
//   its bits, also vary between runs.
// Precision is the plain path's: bf16 operands, f32 accumulators, f32
// softmax, P and dS rounded to bf16 before their products (the autograd
// of layers/sdpa.py rounds the weights and the scores' gradient so). The
// scores are not rounded to bf16 before the scale, as that path's einsum
// rounds them. Causal key tiles with nothing to do are never loaded: a
// key tile starts at the first query tile that reaches it, a query tile
// stops at its last position's key tile. Masked entries are selected to
// 0, never multiplied, so a zero-filled edge (TMA fills past S and T)
// cannot turn into a NaN.
#include <cuda.h>  // CUtensorMap and its enums only: libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_async.cuh"
#include "wgmma.cuh"

namespace repro_torch {
namespace fa_wgmma {

constexpr int kBwdSlots = 2;       // the ring of Q/dO (kv kernel) or K/V (dq kernel) tiles
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kDeltaThreads = 256;

// Delta (B,H,S) f32 = rowsum(dO * O) over D, o and dout (B,S,H,D) bf16:
// warp w takes row w = (b S + s) H + h
__global__ void __launch_bounds__(kDeltaThreads)
fa_bwd_delta_kernel(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                    float* __restrict__ delta, long long rows, int s_len, int n_heads, int d) {
  const long long w = ((long long)blockIdx.x * kDeltaThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= rows) return;
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(o + w * d);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(dout + w * d);
  float sum = 0.f;
  for (int i = lane; i < d / 2; i += 32) {
    const float2 a = __bfloat1622float2(x[i]), g = __bfloat1622float2(y[i]);
    sum += a.x * g.x + a.y * g.y;
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) sum += __shfl_xor_sync(kFullMask, sum, off);
  if (lane == 0) {
    const int h = (int)(w % n_heads);
    const long long bs = w / n_heads;
    delta[(bs / s_len * n_heads + h) * s_len + bs % s_len] = sum;
  }
}

// dK and dV of one 64-key tile of one KV head, over the group's heads
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_kv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                 const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int s_len,
                 int t_len, int n_heads, int n_kv_heads, int group_log2, float scale_log2,
                 float scale) {
  constexpr uint32_t kTile = boxes(D) * kBoxBytes;  // one 64-row tile of a bf16 operand
  constexpr uint32_t kStats = kTile * (2 + 2 * kBwdSlots);  // two buffers of lse, Delta
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = base, v_s = base + kTile;
  const uint32_t bar_kv = base + kStats + 4 * 2 * 2 * kM;  // then one barrier a ring slot
  float* stats = reinterpret_cast<float*>(smem_raw + (base - smem_addr(smem_raw)) + kStats);

  const int group = 1 << group_log2;
  const int rows_pos = kM >> group_log2;  // query positions a tile
  const int m_tiles = (s_len + rows_pos - 1) / rows_pos;
  const int t0 = blockIdx.x * kN;  // the lowest key tiles have the most work, and go first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int i0 = min(t0 / rows_pos, m_tiles);  // the first query tile with a position >= t0
  const int n_q = m_tiles - i0;
  const int tid = threadIdx.x;

  auto load_q = [&](int it) {  // query tile i0 + it (Q and dO) into slot it % kBwdSlots
    const uint32_t slot = (uint32_t)(it % kBwdSlots);
    const uint32_t q_s = base + kTile * (2 + 2 * slot), do_s = q_s + kTile;
    const uint32_t bar = bar_kv + 8 * (1 + slot);
    const int s0 = (i0 + it) * rows_pos;
    mbar_expect_tx(bar, 2 * kTile);
#pragma unroll
    for (int x = 0; x < boxes(D); ++x) {
      tma_load_4d(q_s + x * kBoxBytes, &tq, bar, 64 * x, kvh * group, s0, b);
      tma_load_4d(do_s + x * kBoxBytes, &tdo, bar, 64 * x, kvh * group, s0, b);
    }
  };
  // lse (log2 domain) and Delta of query tile i0 + it's rows into buffer
  // it & 1, one row a thread of the first 64; 0 past S
  auto load_stats = [&](int it) {
    if (tid < kM && it < n_q) {
      const int pos = (i0 + it) * rows_pos + (tid >> group_log2);
      const int head = (kvh << group_log2) + (tid & (group - 1));
      float l = 0.f, dl = 0.f;
      if (pos < s_len) {
        const long long at = ((long long)b * n_heads + head) * s_len + pos;
        l = lse[at] * kLog2e;
        dl = delta[at];
      }
      stats[(it & 1) * 2 * kM + tid] = l;
      stats[(it & 1) * 2 * kM + kM + tid] = dl;
    }
  };
  if (tid == 0) {
    for (int i = 0; i <= kBwdSlots; ++i) mbar_init(bar_kv + 8 * i, 1);
    fence_barrier_init();
    mbar_expect_tx(bar_kv, 2 * kTile);
#pragma unroll
    for (int x = 0; x < boxes(D); ++x) {
      tma_load_4d(k_s + x * kBoxBytes, &tk, bar_kv, 64 * x, kvh, t0, b);
      tma_load_4d(v_s + x * kBoxBytes, &tv, bar_kv, 64 * x, kvh, t0, b);
    }
    for (int it = 0; it < kBwdSlots && it < n_q; ++it) load_q(it);
  }
  load_stats(0);
  __syncthreads();  // barriers initialised, the first stats written

  // this thread's fragment: keys row0 and row0 + 8 of the tile, query rows
  // (columns) 8c + col0 and + 1, c = 0..7
  const int lane = tid & 31;
  const int row0 = (tid >> 5) * 16 + (lane >> 2);
  const int col0 = 2 * (lane & 3);

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  mbar_wait(bar_kv, 0);
  for (int it = 0; it < n_q; ++it) {
    const uint32_t slot = (uint32_t)(it % kBwdSlots);
    const uint32_t q_s = base + kTile * (2 + 2 * slot), do_s = q_s + kTile;
    const int s0 = (i0 + it) * rows_pos;
    mbar_wait(bar_kv + 8 * (1 + slot), (uint32_t)((it / kBwdSlots) & 1));

    // S^T = K Q^T and dP^T = V dO^T (64 keys x 64 query rows, f32)
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
      wgmma_ss_m64n64(s, smem_desc(k_s + off, 16, 1024), smem_desc(q_s + off, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
      wgmma_ss_m64n64(dp, smem_desc(v_s + off, 16, 1024), smem_desc(do_s + off, 16, 1024),
                      kk > 0);
    }
    wgmma_commit();
    load_stats(it + 1);  // the next tile's, while the products run
    fence_regs(s);
    fence_regs(dp);
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // P^T and dS^T, rounded to bf16 as A fragments of four k16 steps over
    // the query rows (the forward's P packing)
    const float* st = stats + (it & 1) * 2 * kM;
    const bool edge = s0 < t0 + kN - 1 || s0 + rows_pos > s_len || t0 + kN > t_len;
    uint32_t pa[16], da[16];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float2 l = *reinterpret_cast<const float2*>(st + 8 * c + col0);
      const float2 dl = *reinterpret_cast<const float2*>(st + kM + 8 * c + col0);
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pe = exp2f(s[4 * c + e] * scale_log2 - ((e & 1) ? l.y : l.x));
        if (edge) {
          const int key = t0 + row0 + 8 * (e >> 1);
          const int pos = s0 + ((8 * c + col0 + (e & 1)) >> group_log2);
          if (key > pos || pos >= s_len || key >= t_len) pe = 0.f;
        }
        p[e] = pe;
        ds[e] = pe * (dp[4 * c + e] - ((e & 1) ? dl.y : dl.x)) * scale;
      }
      pa[2 * c] = pack_bf16(p[0], p[1]);
      pa[2 * c + 1] = pack_bf16(p[2], p[3]);
      da[2 * c] = pack_bf16(ds[0], ds[1]);
      da[2 * c + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dV += P^T dO, dK += dS^T Q (64 keys x D)
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kM / 16; ++kk)
      wgmma_pv<D>(dv_acc, pa + 4 * kk, smem_desc(do_s + kk * 16 * 128, kBoxBytes, 1024));
#pragma unroll
    for (int kk = 0; kk < kM / 16; ++kk)
      wgmma_pv<D>(dk_acc, da + 4 * kk, smem_desc(q_s + kk * 16 * 128, kBoxBytes, 1024));
    wgmma_commit();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wgmma_wait_all();
    fence_regs(dv_acc);
    fence_regs(dk_acc);

    __syncthreads();  // every warp is done with this slot and this stats buffer
    if (tid == 0 && it + kBwdSlots < n_q) load_q(it + kBwdSlots);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = t0 + row0 + 8 * h;
    if (key < t_len) {
      const long long at = (((long long)b * t_len + key) * n_kv_heads + kvh) * D + col0;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        *reinterpret_cast<uint32_t*>(dk + at + 8 * c) =
            pack_bf16(dk_acc[4 * c + 2 * h], dk_acc[4 * c + 2 * h + 1]);
        *reinterpret_cast<uint32_t*>(dv + at + 8 * c) =
            pack_bf16(dv_acc[4 * c + 2 * h], dv_acc[4 * c + 2 * h + 1]);
      }
    }
  }
}

// dQ of one 64-row query tile (64/G positions x the group's G heads)
template <int D>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                 const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dq, int s_len, int t_len, int n_heads,
                 int group_log2, float scale_log2, float scale) {
  constexpr uint32_t kTile = boxes(D) * kBoxBytes;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base, do_s = base + kTile;
  const uint32_t bar_q = base + kTile * (2 + 2 * kBwdSlots);

  const int group = 1 << group_log2;
  const int rows_pos = kM >> group_log2;
  const int m_tiles = (s_len + rows_pos - 1) / rows_pos;
  const int s0 = (m_tiles - 1 - (int)blockIdx.x) * rows_pos;  // heaviest tiles first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int last_key = min(min(s0 + rows_pos, s_len) - 1, t_len - 1);
  const int n_tiles = last_key / kN + 1;
  const int tid = threadIdx.x;

  auto load_kv = [&](int j) {  // key tile j into slot j % kBwdSlots (one thread)
    const uint32_t slot = (uint32_t)(j % kBwdSlots);
    const uint32_t k_s = base + kTile * (2 + 2 * slot), v_s = k_s + kTile;
    const uint32_t bar = bar_q + 8 * (1 + slot);
    mbar_expect_tx(bar, 2 * kTile);
#pragma unroll
    for (int x = 0; x < boxes(D); ++x) {
      tma_load_4d(k_s + x * kBoxBytes, &tk, bar, 64 * x, kvh, j * kN, b);
      tma_load_4d(v_s + x * kBoxBytes, &tv, bar, 64 * x, kvh, j * kN, b);
    }
  };
  if (tid == 0) {
    for (int i = 0; i <= kBwdSlots; ++i) mbar_init(bar_q + 8 * i, 1);
    fence_barrier_init();
    mbar_expect_tx(bar_q, 2 * kTile);
#pragma unroll
    for (int x = 0; x < boxes(D); ++x) {
      tma_load_4d(q_s + x * kBoxBytes, &tq, bar_q, 64 * x, kvh * group, s0, b);
      tma_load_4d(do_s + x * kBoxBytes, &tdo, bar_q, 64 * x, kvh * group, s0, b);
    }
    for (int j = 0; j < kBwdSlots && j < n_tiles; ++j) load_kv(j);
  }
  __syncthreads();

  // this thread's rows row0 and row0 + 8 (position, head), and their stats
  const int lane = tid & 31;
  const int row0 = (tid >> 5) * 16 + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  int pos[2], head[2];
  float l2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    pos[h] = s0 + ((row0 + 8 * h) >> group_log2);
    head[h] = (kvh << group_log2) + ((row0 + 8 * h) & (group - 1));
    l2[h] = dl[h] = 0.f;
    if (pos[h] < s_len) {
      const long long at = ((long long)b * n_heads + head[h]) * s_len + pos[h];
      l2[h] = lse[at] * kLog2e;
      dl[h] = delta[at];
    }
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(bar_q, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const uint32_t slot = (uint32_t)(j % kBwdSlots);
    const uint32_t k_s = base + kTile * (2 + 2 * slot), v_s = k_s + kTile;
    mbar_wait(bar_q + 8 * (1 + slot), (uint32_t)((j / kBwdSlots) & 1));

    // S = Q K^T and dP = dO V^T (64 query rows x 64 keys, f32)
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
      wgmma_ss_m64n64(s, smem_desc(q_s + off, 16, 1024), smem_desc(k_s + off, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
      wgmma_ss_m64n64(dp, smem_desc(do_s + off, 16, 1024), smem_desc(v_s + off, 16, 1024),
                      kk > 0);
    }
    wgmma_commit();
    fence_regs(s);
    fence_regs(dp);
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    const int t0 = j * kN;
    const bool edge = t0 + kN > t_len || t0 + kN - 1 > s0;
    uint32_t da[16];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float pe = exp2f(s[4 * c + e] * scale_log2 - l2[h]);
        if (edge) {
          const int t = t0 + 8 * c + col0 + (e & 1);
          if (t >= t_len || t > pos[h]) pe = 0.f;
        }
        ds[e] = pe * (dp[4 * c + e] - dl[h]) * scale;
      }
      da[2 * c] = pack_bf16(ds[0], ds[1]);
      da[2 * c + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dQ += dS K (64 x D; K MN-major, as V in the forward's P V)
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk)
      wgmma_pv<D>(acc, da + 4 * kk, smem_desc(k_s + kk * 16 * 128, kBoxBytes, 1024));
    wgmma_commit();
    fence_regs(acc);
    wgmma_wait_all();
    fence_regs(acc);

    __syncthreads();  // every warp is done with this slot
    if (tid == 0 && j + kBwdSlots < n_tiles) load_kv(j + kBwdSlots);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (pos[h] < s_len) {
      __nv_bfloat16* out = dq + (((long long)b * s_len + pos[h]) * n_heads + head[h]) * D + col0;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        *reinterpret_cast<uint32_t*>(out + 8 * c) =
            pack_bf16(acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1]);
    }
  }
}

template <int D>
static int launch_bwd(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const float* lse, float* delta, void* dq, void* dk,
                      void* dv, int b, int s_len, int t_len, int n_heads, int n_kv_heads,
                      int group_log2, cudaStream_t stream) {
  EncodeTiled fn;
  cudaError_t err = get_encode_tiled(&fn);
  if (err != cudaSuccess) return (int)err;
  const int group = 1 << group_log2;
  CUtensorMap tq, tdo, tk, tv;
  if (!encode(fn, &tq, q, b, s_len, n_heads, D, group, kM / group) ||
      !encode(fn, &tdo, dout, b, s_len, n_heads, D, group, kM / group) ||
      !encode(fn, &tk, k, b, t_len, n_kv_heads, D, 1, kN) ||
      !encode(fn, &tv, v, b, t_len, n_kv_heads, D, 1, kN))
    return (int)cudaErrorInvalidValue;
  constexpr int kTile = boxes(D) * (int)kBoxBytes;
  const int dq_smem = kTile * (2 + 2 * kBwdSlots) + 8 * (1 + kBwdSlots) + 1024;
  const int kv_smem = dq_smem + 4 * 2 * 2 * kM;
  err = cudaFuncSetAttribute(fa_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dq_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fa_bwd_kv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kv_smem);
  if (err != cudaSuccess) return (int)err;
  const float scale = 1.0f / sqrtf((float)D);
  const float scale_log2 = kLog2e * scale;

  const long long rows = (long long)b * s_len * n_heads;
  const long long warps_a_block = kDeltaThreads / 32;
  fa_bwd_delta_kernel<<<(unsigned)((rows + warps_a_block - 1) / warps_a_block), kDeltaThreads, 0,
                        stream>>>(static_cast<const __nv_bfloat16*>(o),
                                  static_cast<const __nv_bfloat16*>(dout), delta, rows, s_len,
                                  n_heads, D);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int rows_pos = kM / group;
  const dim3 q_grid((unsigned)((s_len + rows_pos - 1) / rows_pos), (unsigned)n_kv_heads,
                    (unsigned)b);
  fa_bwd_dq_kernel<D><<<q_grid, kThreads, dq_smem, stream>>>(
      tq, tdo, tk, tv, lse, delta, static_cast<__nv_bfloat16*>(dq), s_len, t_len, n_heads,
      group_log2, scale_log2, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const dim3 k_grid((unsigned)((t_len + kN - 1) / kN), (unsigned)n_kv_heads, (unsigned)b);
  fa_bwd_kv_kernel<D><<<k_grid, kThreads, kv_smem, stream>>>(
      tq, tdo, tk, tv, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), s_len, t_len, n_heads, n_kv_heads, group_log2, scale_log2,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace fa_wgmma
}  // namespace repro_torch

// The causal attention's gradient. q, o, dout, dq (B,S,H,D); k, v, dk, dv
// (B,T,K,D): all contiguous bf16, 16-byte aligned. lse (B,H,S) f32 from
// repro_torch_flash_attention_train_fwd; delta (B,H,S) f32 scratch. D 64
// or 128; H / K a power of two that divides 64. Returns cudaGetLastError()
// after the last of the three launches (or the error that stopped them).
extern "C" int repro_torch_flash_attention_bwd(const void* q, const void* k, const void* v,
                                               const void* o, const void* dout, const void* lse,
                                               void* delta, void* dq, void* dk, void* dv, int b,
                                               int s_len, int t_len, int n_heads,
                                               int n_kv_heads, int d_head, void* stream) {
  using namespace repro_torch::fa_wgmma;
  const int group_log2 = group_log2_of(n_heads, n_kv_heads);
  if (group_log2 < 0) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (d_head == 64)
    return launch_bwd<64>(q, k, v, o, dout, l, dl, dq, dk, dv, b, s_len, t_len, n_heads,
                          n_kv_heads, group_log2, st);
  if (d_head == 128)
    return launch_bwd<128>(q, k, v, o, dout, l, dl, dq, dk, dv, b, s_len, t_len, n_heads,
                           n_kv_heads, group_log2, st);
  return (int)cudaErrorInvalidValue;
}
