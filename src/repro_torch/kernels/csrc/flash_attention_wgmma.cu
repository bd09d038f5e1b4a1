// flash_attention, bf16 on the tensor cores: causal / non-causal GQA
// attention forward for head dims 64, 128 and 160 (stablelm-12b's) and
// groups H/K that divide 64.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, pallas_call at :104) for those calls; f32 calls and
// other head dims go to the CUDA-core kernel in flash_attention.cu (TF32
// would miss f32's 2e-5 tolerance). kernels/ops.py routes each call by
// dtype, D and group alone, before the launch.
//
// What bounds it on an H100: at the serving prefill shape (q (1,128,32,128),
// k/v (1,128,8,128)) latency: 2.6 MB of q/k/v/o, 0.78 us at 3.35 TB/s, for
// 0.14 GFLOP of causal work. At a 4,096-token context the causal products
// are 1.37e11 FLOP, 0.139 ms at the 989 TFLOP/s bf16 peak, against 84 MB
// (25 us): operations. Both products are bf16 with f32 accumulation, as
// the TPU kernel's dot_generals are, which is what wgmma does.
//
// Design (one warpgroup of 128 threads a block):
// - A block takes one KV head of one batch row and a 64-row query tile,
//   which packs 64/G positions x the G heads of the group (the heads of a
//   group are adjacent in q (B,S,H,D), so one 4-D TMA box (64 dims, G
//   heads, 64/G positions, 1) loads it; row r is position r / G, head
//   r % G). Each K/V tile is then loaded once per group, not once per head.
// - TMA tiled loads in the 128-byte swizzle, 64 dims (128 bytes) a box:
//   the Q tile, and 64-key K and V tiles through a two-slot ring, one
//   mbarrier each; one thread keeps the next K/V tile in flight while the
//   warpgroup computes on this one. Tensor maps are encoded on the host
//   (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so
//   only libcudart is linked) and passed as __grid_constant__ parameters,
//   which CUDA graphs capture with the launch.
// - S = Q K^T: wgmma m64n64k16 over D/16 k-steps, both operands from
//   shared memory (K-major descriptors: 128-byte swizzle, 1,024-byte
//   stride between 8-row groups, k-steps 32 bytes apart in a 64-dim box).
// - Online softmax on the accumulator fragment in f32 (exp2 with the
//   scale folded in): a thread holds 16 scores of 2 rows, row max and sum
//   are shuffles within the quad. Keys >= T, and in causal mode keys past
//   the row's position, score -1e30 (never -inf), only on tiles that can
//   hold such keys; key tiles past the tile's last causal position are
//   never loaded. p is rounded to bf16 before P V (the TPU kernel's
//   p.astype(v.dtype)); l sums the unrounded p.
// - O += P V: wgmma m64n{D}k16 with P from registers (the S fragment
//   repacked as bf16 pairs is the A fragment) and V from shared memory,
//   MN-major (transpose bit; 8,192 bytes between the 64-dim boxes).
// - Head dim 160: a row is three 64-dim boxes, the tensor map's row is
//   160 dims, so TMA zero-fills dims 160-191 of the third box of Q, K and
//   V (and still counts the whole box on the mbarrier). QK^T runs its
//   D/16 = 10 k-steps; P V runs m64n192 over the three whole boxes (the
//   zero-filled dims add zero columns), with 96 accumulators a thread, and
//   only the first 160 columns are written. Shared memory: 5 tiles of 3
//   boxes, 120 KB.
// - Output: acc / max(l, 1e-30) as bf16 straight from the registers;
//   rows past S are not written. TMA zero-fills boxes past S and T, and
//   the mask and the row guard keep ragged edges exact.
// - Causal tiles run heaviest first (the grid's x axis reversed).
// - The training forward (fa_train_fwd_kernel, D 64/128, causal) is the
//   same body with one more epilogue store: each row's log-sum-exp
//   (m + log2 l) ln 2, into lse (B, H, S) f32, for the backward
//   (flash_attention_bwd.cu). It replaces no TPU kernel: the JAX package's
//   training attention is jnp outside any Pallas kernel; it is here so the
//   training step never writes its S x T scores to device memory.
//   fa_wgmma_kernel, the serving prefill's, compiles without that store.
#include <cuda.h>  // CUtensorMap and its enums only: libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_async.cuh"
#include "wgmma.cuh"

namespace repro_torch {
namespace fa_wgmma {

// The kernel's body; kLse also writes each row's log-sum-exp of its scaled
// scores (natural log, lse (B, H, S) f32), which the training backward
// (flash_attention_bwd.cu) recomputes P from. Without it the code is the
// serving prefill's kernel as it was.
template <int D, bool kLse>
__device__ __forceinline__ void fa_forward(const CUtensorMap& tq, const CUtensorMap& tk,
                                           const CUtensorMap& tv, __nv_bfloat16* __restrict__ o,
                                           float* __restrict__ lse, int s_len, int t_len,
                                           int n_heads, int group_log2, int causal,
                                           float scale_log2) {
  constexpr int kBoxes = boxes(D);             // 64-dim boxes a row
  constexpr int kPV = pv_width(D);             // P V's N: whole boxes
  constexpr uint32_t kTile = kBoxes * kBoxBytes;  // one 64-row tile of Q, K or V
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1,024 bytes: tiles start on it
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t bar_q = base + kTile * (1 + 2 * kSlots);

  const int group = 1 << group_log2;
  const int rows_pos = kM >> group_log2;  // query positions a tile
  const int m_tiles = (s_len + rows_pos - 1) / rows_pos;
  const int s0 = (m_tiles - 1 - (int)blockIdx.x) * rows_pos;  // heaviest causal tiles first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int last_pos = min(s0 + rows_pos, s_len) - 1;
  const int last_key = causal ? min(last_pos, t_len - 1) : t_len - 1;
  const int n_tiles = last_key / kN + 1;
  const int tid = threadIdx.x;

  auto load_kv = [&](int j) {  // tile j into slot j % kSlots (one thread)
    const uint32_t slot = (uint32_t)(j % kSlots);
    const uint32_t k_s = base + kTile * (1 + 2 * slot), v_s = k_s + kTile;
    const uint32_t bar = bar_q + 8 * (1 + slot);
    mbar_expect_tx(bar, 2 * kTile);
#pragma unroll
    for (int x = 0; x < kBoxes; ++x) {
      tma_load_4d(k_s + x * kBoxBytes, &tk, bar, 64 * x, kvh, j * kN, b);
      tma_load_4d(v_s + x * kBoxBytes, &tv, bar, 64 * x, kvh, j * kN, b);
    }
  };
  if (tid == 0) {
    for (int i = 0; i <= kSlots; ++i) mbar_init(bar_q + 8 * i, 1);
    fence_barrier_init();
    mbar_expect_tx(bar_q, kTile);
#pragma unroll
    for (int x = 0; x < kBoxes; ++x)
      tma_load_4d(q_s + x * kBoxBytes, &tq, bar_q, 64 * x, kvh * group, s0, b);
    for (int j = 0; j < kSlots && j < n_tiles; ++j) load_kv(j);
  }
  __syncthreads();  // the barriers are initialised before anyone waits on them

  // this thread's two rows of the tile (wgmma fragment: warp w holds rows
  // 16w..16w+15, lane l rows l/4 and l/4 + 8, columns 2(l%4), +1 of each 8)
  const int lane = tid & 31;
  const int row0 = (tid >> 5) * 16 + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  int pos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) pos[h] = s0 + ((row0 + 8 * h) >> group_log2);

  float acc[kPV / 2];
#pragma unroll
  for (int i = 0; i < kPV / 2; ++i) acc[i] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};

  mbar_wait(bar_q, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const uint32_t slot = (uint32_t)(j % kSlots);
    const uint32_t k_s = base + kTile * (1 + 2 * slot), v_s = k_s + kTile;
    mbar_wait(bar_q + 8 * (1 + slot), (uint32_t)((j / kSlots) & 1));

    // S = Q K^T (64 x 64, f32)
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
      wgmma_ss_m64n64(s, smem_desc(q_s + off, 16, 1024), smem_desc(k_s + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    fence_regs(s);
    wgmma_wait_all();
    fence_regs(s);

    // online softmax over this tile, in the log2 domain
    const int t0 = j * kN;
    const bool edge = t0 + kN > t_len || (causal && t0 + kN - 1 > s0);
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int c = 0; c < 8; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * c + e] * scale_log2;
        if (edge) {
          const int t = t0 + 8 * c + col0 + (e & 1);
          if (t >= t_len || (causal && t > pos[e >> 1])) x = kNegInf;
        }
        s[4 * c + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFullMask, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFullMask, mx[h], 2));
      corr[h] = exp2f(m_run[h] - mx[h]);
      m_run[h] = mx[h];
      l_run[h] *= corr[h];  // this thread's share of l; the quad is summed at the end
    }
    // P as the A fragment of four k16 steps: step kk is column chunks 2kk
    // and 2kk+1, registers (row0, c), (row0+8, c), (row0, c+1), (row0+8, c+1)
    uint32_t pa[16];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float p0 = exp2f(s[4 * c] - mx[0]), p1 = exp2f(s[4 * c + 1] - mx[0]);
      const float p2 = exp2f(s[4 * c + 2] - mx[1]), p3 = exp2f(s[4 * c + 3] - mx[1]);
      l_run[0] += p0 + p1;
      l_run[1] += p2 + p3;
      pa[2 * c] = pack_bf16(p0, p1);
      pa[2 * c + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      acc[4 * c] *= corr[0];
      acc[4 * c + 1] *= corr[0];
      acc[4 * c + 2] *= corr[1];
      acc[4 * c + 3] *= corr[1];
    }

    // O += P V (64 x kPV; the columns past D stay zero)
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk)
      wgmma_pv<kPV>(acc, pa + 4 * kk, smem_desc(v_s + kk * 16 * 128, kBoxBytes, 1024));
    wgmma_commit();
    fence_regs(acc);
    wgmma_wait_all();
    fence_regs(acc);

    __syncthreads();  // every warp is done with this slot
    if (tid == 0 && j + kSlots < n_tiles) load_kv(j + kSlots);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(kFullMask, l, 1);
    l += __shfl_xor_sync(kFullMask, l, 2);
    l = fmaxf(l, 1e-30f);
    const int row = row0 + 8 * h;
    if (pos[h] < s_len) {
      const int head = (kvh << group_log2) + (row & (group - 1));
      __nv_bfloat16* out = o + (((long long)b * s_len + pos[h]) * n_heads + head) * D + col0;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        *reinterpret_cast<uint32_t*>(out + 8 * c) =
            pack_bf16(acc[4 * c + 2 * h] / l, acc[4 * c + 2 * h + 1] / l);
      if constexpr (kLse) {  // m_run and l are in the log2 domain of the scaled scores
        if ((lane & 3) == 0)
          lse[((long long)b * n_heads + head) * s_len + pos[h]] =
              (m_run[h] + log2f(l)) * 0.6931471805599453f;
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
fa_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                int s_len, int t_len, int n_heads, int group_log2, int causal,
                float scale_log2) {
  fa_forward<D, false>(tq, tk, tv, o, nullptr, s_len, t_len, n_heads, group_log2, causal,
                       scale_log2);
}

// the training forward: the same, causal, with the log-sum-exp
template <int D>
__global__ void __launch_bounds__(kThreads)
fa_train_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                    float* __restrict__ lse, int s_len, int t_len, int n_heads, int group_log2,
                    float scale_log2) {
  fa_forward<D, true>(tq, tk, tv, o, lse, s_len, t_len, n_heads, group_log2, 1, scale_log2);
}

// q's, k's and v's tensor maps and the dynamic shared memory the kernel
// asks for, or the error that keeps them from being made
template <int D>
static cudaError_t prepare(const void* q, const void* k, const void* v, int b, int s_len,
                           int t_len, int n_heads, int n_kv_heads, int group_log2,
                           CUtensorMap* tq, CUtensorMap* tk, CUtensorMap* tv, int* smem) {
  EncodeTiled fn;
  cudaError_t err = get_encode_tiled(&fn);
  if (err != cudaSuccess) return err;
  const int group = 1 << group_log2;
  if (!encode(fn, tq, q, b, s_len, n_heads, D, group, kM / group) ||
      !encode(fn, tk, k, b, t_len, n_kv_heads, D, 1, kN) ||
      !encode(fn, tv, v, b, t_len, n_kv_heads, D, 1, kN))
    return cudaErrorInvalidValue;
  *smem = (int)(boxes(D) * kBoxBytes * (1 + 2 * kSlots) + 8 * (1 + kSlots) + 1024);
  return cudaSuccess;
}

static dim3 grid_of(int b, int s_len, int n_kv_heads, int group_log2) {
  const int rows_pos = kM >> group_log2;
  return dim3((unsigned)((s_len + rows_pos - 1) / rows_pos), (unsigned)n_kv_heads, (unsigned)b);
}

template <int D>
static int launch(const void* q, const void* k, const void* v, void* o, int b, int s_len,
                  int t_len, int n_heads, int n_kv_heads, int group_log2, int causal,
                  cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int smem = 0;
  cudaError_t err = prepare<D>(q, k, v, b, s_len, t_len, n_heads, n_kv_heads, group_log2, &tq,
                               &tk, &tv, &smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(fa_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  fa_wgmma_kernel<D><<<grid_of(b, s_len, n_kv_heads, group_log2), kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), s_len, t_len, n_heads, group_log2, causal,
      scale_log2);
  return (int)cudaGetLastError();
}

template <int D>
static int launch_train(const void* q, const void* k, const void* v, void* o, float* lse, int b,
                        int s_len, int t_len, int n_heads, int n_kv_heads, int group_log2,
                        cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int smem = 0;
  cudaError_t err = prepare<D>(q, k, v, b, s_len, t_len, n_heads, n_kv_heads, group_log2, &tq,
                               &tk, &tv, &smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(fa_train_fwd_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  fa_train_fwd_kernel<D><<<grid_of(b, s_len, n_kv_heads, group_log2), kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, s_len, t_len, n_heads, group_log2,
      scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace fa_wgmma
}  // namespace repro_torch

// q (B,S,H,D), k/v (B,T,K,D), o (B,S,H,D), all contiguous bf16 and 16-byte
// aligned; D 64, 128 or 160; H / K a power of two that divides 64. Returns
// cudaGetLastError() after the launch (or the error that kept it from one).
extern "C" int repro_torch_flash_attention_wgmma(const void* q, const void* k, const void* v,
                                                 void* o, int b, int s_len, int t_len,
                                                 int n_heads, int n_kv_heads, int d_head,
                                                 int causal, void* stream) {
  using namespace repro_torch::fa_wgmma;
  const int group_log2 = group_log2_of(n_heads, n_kv_heads);
  if (group_log2 < 0) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (d_head == 64)
    return launch<64>(q, k, v, o, b, s_len, t_len, n_heads, n_kv_heads, group_log2, causal, st);
  if (d_head == 128)
    return launch<128>(q, k, v, o, b, s_len, t_len, n_heads, n_kv_heads, group_log2, causal, st);
  if (d_head == 160)
    return launch<160>(q, k, v, o, b, s_len, t_len, n_heads, n_kv_heads, group_log2, causal, st);
  return (int)cudaErrorInvalidValue;
}


// The training forward: causal, q (B,S,H,D), k/v (B,T,K,D), o (B,S,H,D) as
// above, and lse (B,H,S) f32, each row's log-sum-exp of its scaled scores;
// D 64 or 128 (the backward's head dims).
extern "C" int repro_torch_flash_attention_train_fwd(const void* q, const void* k,
                                                     const void* v, void* o, void* lse, int b,
                                                     int s_len, int t_len, int n_heads,
                                                     int n_kv_heads, int d_head, void* stream) {
  using namespace repro_torch::fa_wgmma;
  const int group_log2 = group_log2_of(n_heads, n_kv_heads);
  if (group_log2 < 0) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (d_head == 64)
    return launch_train<64>(q, k, v, o, l, b, s_len, t_len, n_heads, n_kv_heads, group_log2, st);
  if (d_head == 128)
    return launch_train<128>(q, k, v, o, l, b, s_len, t_len, n_heads, n_kv_heads, group_log2, st);
  return (int)cudaErrorInvalidValue;
}
