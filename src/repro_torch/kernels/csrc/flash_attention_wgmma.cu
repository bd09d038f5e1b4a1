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
#include <cuda.h>  // CUtensorMap and its enums only: libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_async.cuh"

namespace repro_torch {
namespace fa_wgmma {

constexpr int kM = 64;                 // query rows a block (the wgmma M)
constexpr int kN = 64;                 // keys a tile
constexpr int kThreads = 128;          // one warpgroup
constexpr int kSlots = 2;              // K/V ring
constexpr uint32_t kBoxBytes = 64 * 128;  // one 64-row x 64-dim bf16 box
constexpr float kNegInf = -1e30f;      // the TPU kernel's mask value
constexpr unsigned kFullMask = 0xffffffffu;

// d (m64n64, f32) = A·B (scale_d = 0) or d + A·B, A (64 x 16) and B
// (16 x 64) bf16 K-major in shared memory, given by descriptors
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (m64n64, f32) += A·B, A (64 x 16) bf16 from registers (four bf16x2
// a thread), B (16 x 64) bf16 MN-major in shared memory (transpose bit set)
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64n128, f32) += A·B, A (64 x 16) bf16 from registers (four bf16x2
// a thread), B (16 x 128) bf16 MN-major in shared memory (transpose bit set)
__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving accesses to wgmma registers across the
// async window
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (m64n192, f32) += A·B, A (64 x 16) bf16 from registers (four bf16x2
// a thread), B (16 x 192) bf16 MN-major in shared memory (transpose bit set)
__device__ __forceinline__ void wgmma_rs_m64n192(float (&d)[96], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 64-dim boxes a row of head dim D, and the P V width they cover
__host__ __device__ constexpr int boxes(int d) { return (d + 63) / 64; }
__host__ __device__ constexpr int pv_width(int d) { return 64 * boxes(d); }

template <int N>
__device__ __forceinline__ void wgmma_pv(float (&o)[N / 2], const uint32_t* a, uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32], const uint32_t* a, uint64_t db) {
  wgmma_rs_m64n64(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64], const uint32_t* a, uint64_t db) {
  wgmma_rs_m64n128(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<192>(float (&o)[96], const uint32_t* a, uint64_t db) {
  wgmma_rs_m64n192(o, a, db);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
fa_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                int s_len, int t_len, int n_heads, int group_log2, int causal,
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
    }
  }
}

// 4-D bf16 map of a contiguous (B, rows, heads, D) tensor, box (64 dims,
// box_heads, box_rows, 1) in the 128-byte swizzle; out of range reads 0
static bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int b, int rows, int heads,
                   int d, int box_heads, int box_rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)rows, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)heads * d * 2,
                                 (cuuint64_t)rows * heads * d * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_heads, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
static int launch(const void* q, const void* k, const void* v, void* o, int b, int s_len,
                  int t_len, int n_heads, int n_kv_heads, int group_log2, int causal,
                  cudaStream_t stream) {
  EncodeTiled fn;
  cudaError_t err = get_encode_tiled(&fn);
  if (err != cudaSuccess) return (int)err;
  const int group = 1 << group_log2;
  CUtensorMap tq, tk, tv;
  if (!encode(fn, &tq, q, b, s_len, n_heads, D, group, kM / group) ||
      !encode(fn, &tk, k, b, t_len, n_kv_heads, D, 1, kN) ||
      !encode(fn, &tv, v, b, t_len, n_kv_heads, D, 1, kN))
    return (int)cudaErrorInvalidValue;
  const int smem = (int)(boxes(D) * kBoxBytes * (1 + 2 * kSlots) + 8 * (1 + kSlots) + 1024);
  err = cudaFuncSetAttribute(fa_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  const int rows_pos = kM / group;
  const dim3 grid((unsigned)((s_len + rows_pos - 1) / rows_pos), (unsigned)n_kv_heads,
                  (unsigned)b);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  fa_wgmma_kernel<D><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), s_len, t_len, n_heads, group_log2, causal,
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
  if (n_kv_heads < 1 || n_heads % n_kv_heads) return (int)cudaErrorInvalidValue;
  const int group = n_heads / n_kv_heads;
  int group_log2 = 0;
  while ((1 << group_log2) < group) ++group_log2;
  if ((1 << group_log2) != group || group > kM) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (d_head == 64)
    return launch<64>(q, k, v, o, b, s_len, t_len, n_heads, n_kv_heads, group_log2, causal, st);
  if (d_head == 128)
    return launch<128>(q, k, v, o, b, s_len, t_len, n_heads, n_kv_heads, group_log2, causal, st);
  if (d_head == 160)
    return launch<160>(q, k, v, o, b, s_len, t_len, n_heads, n_kv_heads, group_log2, causal, st);
  return (int)cudaErrorInvalidValue;
}
