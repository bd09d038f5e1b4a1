// rglru_scan: the RG-LRU linear recurrence over (B, T, W) f32,
//   forward   h_t = a_t * h_{t-1} + x_t,              h_{-1} = 0,
//   backward  g_t = dh_t + a_{t+1} * g_{t+1},         g_T = 0, a_T = 0,
//             dx_t = g_t,  da_t = g_t * h_{t-1}.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py
// (rglru_scan, pallas_call at :58), which the RG-LRU layer's
// associative_scan computes on the JAX path (layers/rglru.py). The TPU
// kernel has no backward (JAX differentiates the scan); the backward is the
// same recurrence run from the last step to the first, so each kernel here
// takes a direction flag and gives both passes, bound to autograd by
// ops.RGLRUScan.
//
// What bounds it on an H100: bytes. Each step is one multiply and one add
// per channel; the forward moves 12 bytes a step (a, x in; h out), the
// backward 20 (a, h, dh in; dx, da out): 125.8 and 209.7 MB at the
// training path's shape (1, 4096, 2560), 37.6 and 62.6 us at 3.35 TB/s.
// The time axis is a chain of dependent steps, but one f32 multiply and one
// add a step is ~8 cycles, so 4,096 steps take ~18 us: under the bound.
// What has to be found is enough bytes in flight (~3 MB across the card to
// cover ~1 us of latency) with only B * W = 2,560 independent channels.
//
// scan_ring_kernel (the main path; W % 4 == 0, operands 16-byte aligned):
// - A block of one warp owns a strip of kStrip = 32 channels (a 128-byte
//   row a step) of one batch row: 80 blocks at W = 2,560.
// - Time tiles [128 steps x 32] of every input stream from device memory by
//   TMA (3-D tensor maps over (W, T, B)) into a shared-memory ring of up to
//   96 KB, one mbarrier a stage: lane 0 keeps every stage in flight and
//   refills a stage as soon as the warp has walked it, so ~96 KB a block
//   (~7.7 MB across the card) is in flight instead of ~256 bytes a thread.
// - Lane c walks its channel through the tile from shared memory, 8 steps
//   at a time through registers with the next 8 steps' loads started first,
//   and writes outputs into a staging tile, which lane 0 stores by TMA
//   (two staging buffers, so one store drains while the next tile runs).
// - The reverse pass needs h_{t-1}: its h box starts one step earlier, and
//   at t = 0 TMA's zero fill of coordinate -1 gives h_{-1} = 0 at each
//   batch row's own edge (a 2-D (B*T, W) view would read the previous
//   row's last step instead). Ragged W and T are zero-filled on load and
//   clipped on store by TMA.
// - Tried and not kept (H100, PERF.md): strips of 8 and 16 channels
//   (320 and 160 blocks, every SM busy) ran slower than 32 (at 16 the
//   backward's ring and staging need 128 KB, one block an SM, so 160
//   blocks take two waves); 64-step tiles, 16-step register batches and a
//   128-160 KB ring were level or slower; walking each step's loads and
//   store in order (no register batches) cost 108 / 197 us, one shared-
//   memory round trip a step.
//
// rglru_scan_kernel (the first design; W % 4 != 0 or a misaligned
// operand, which a tensor map cannot describe; ops._scan_kernel routes):
// one thread per (b, w) channel, walking time; 32 channels per block.
// Neighbouring threads read neighbouring w, so each step's loads are one
// coalesced line per warp. A thread loads the next kSteps steps' inputs
// into registers (all independent loads, in flight together), then runs
// them through the recurrence. Whole batches run unguarded on pointers
// that advance by a batch; only the last 1..kSteps steps test their bounds.
//
// Both kernels keep the arithmetic bit for bit: __fmul_rn / __fadd_rn keep
// nvcc from contracting a step into an FMA, so both directions round as the
// plain versions in kernels/ref.py do (one multiply, then one add, per
// step). A chunked two-pass scan (more parallelism over T) would round
// differently; it is not done.
#include <cuda_runtime.h>

#include "hopper_async.cuh"

namespace repro_torch {

constexpr int kThreads = 32;  // channels per block
constexpr int kSteps = 32;    // time steps loaded ahead per thread

// One batch of up to kSteps steps from the pointers' current step; step u
// is u * stride elements on. kTail: only the first n steps exist, and in
// reverse the last of them is t = 0, whose h_{t-1} is zero.
template <bool kReverse, bool kTail>
__device__ __forceinline__ void scan_batch(const float* __restrict__ a,
                                           const float* __restrict__ in,
                                           const float* __restrict__ h_prev,
                                           float* __restrict__ out, float* __restrict__ da,
                                           long long stride, int n, int W, float& carry,
                                           float& a_next) {
  float ra[kSteps], rin[kSteps], rh[kSteps];
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    if (!kTail || u < n) {
      ra[u] = __ldg(a + u * stride);
      rin[u] = __ldg(in + u * stride);
      if (kReverse) rh[u] = (!kTail || u < n - 1) ? __ldg(h_prev + u * stride - W) : 0.0f;
    }
  }
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    if (!kTail || u < n) {
      const float coef = kReverse ? a_next : ra[u];
      carry = __fadd_rn(__fmul_rn(coef, carry), rin[u]);
      out[u * stride] = carry;
      if (kReverse) {
        da[u * stride] = __fmul_rn(carry, rh[u]);
        a_next = ra[u];
      }
    }
  }
}

// kReverse = false: in = x, out = h; h_prev and da unused (null).
// kReverse = true:  in = dh, out = dx, h_prev = the forward's h, da written.
// Step s visits time t = s (forward) or t = T - 1 - s (reverse).
template <bool kReverse>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ in,
                  const float* __restrict__ h_prev, float* __restrict__ out,
                  float* __restrict__ da, int T, int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const long long stride = kReverse ? -(long long)W : (long long)W;
  const long long first =
      (long long)blockIdx.y * T * W + w + (kReverse ? (long long)(T - 1) * W : 0);
  a += first;
  in += first;
  out += first;
  if (kReverse) {
    h_prev += first;
    da += first;
  }
  float carry = 0.0f;  // h_{t-1} forward, g_{t+1} reverse
  float a_next = 0.0f; // reverse: a_{t+1}, zero past the last step
  int s0 = 0;
  for (; s0 + kSteps < T; s0 += kSteps) {  // whole batches; none reaches t = 0 in reverse
    scan_batch<kReverse, false>(a, in, h_prev, out, da, stride, kSteps, W, carry, a_next);
    const long long jump = kSteps * stride;
    a += jump;
    in += jump;
    out += jump;
    if (kReverse) {
      h_prev += jump;
      da += jump;
    }
  }
  scan_batch<kReverse, true>(a, in, h_prev, out, da, stride, T - s0, W, carry, a_next);
}

}  // namespace repro_torch

// All tensors (B,T,W) f32, contiguous, on one device; B <= 65535, T, W >= 1.
// Returns cudaGetLastError().
extern "C" int repro_torch_rglru_scan(const void* a, const void* x, void* h,
                                      int B, int T, int W, void* stream) {
  using namespace repro_torch;
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)x, nullptr, (float*)h, nullptr, T, W);
  return (int)cudaGetLastError();
}

extern "C" int repro_torch_rglru_scan_bwd(const void* a, const void* h,
                                          const void* dh, void* dx, void* da,
                                          int B, int T, int W, void* stream) {
  using namespace repro_torch;
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)dh, (const float*)h, (float*)dx, (float*)da,
      T, W);
  return (int)cudaGetLastError();
}

namespace repro_torch {
namespace scan_ring {

constexpr int kStrip = 32;             // channels a block
static_assert(kStrip == 32, "a block is one warp, one lane a channel");
constexpr int kTileT = 128;            // time steps a tile
constexpr int kU = 8;                   // steps a thread loads into registers at once
constexpr int kRingBytes = 96 * 1024;  // input stages a block keeps in flight

constexpr int clamp_stages(int n) { return n < 2 ? 2 : (n > 16 ? 16 : n); }

// Shared-memory layout: the ring [stages][inputs][tile], two staging
// buffers [2][outputs][tile], one mbarrier a stage.
template <bool kReverse>
struct Ring {
  static constexpr int kIn = kReverse ? 3 : 2;  // a, x | a, dh, h (one step earlier)
  static constexpr int kOut = kReverse ? 2 : 1; // h | dx, da
  static constexpr int kTile = kTileT * kStrip; // floats
  static constexpr int kTileBytes = kTile * 4;
  static constexpr int kStages = clamp_stages(kRingBytes / (kIn * kTileBytes));
  static constexpr int kSmem = (kStages * kIn + 2 * kOut) * kTileBytes + 8 * kStages + 128;
};

// grid (ceil(W / kStrip), B), one warp. kReverse = false: map_in = x, map_out
// = h (map_h, map_da unused). kReverse = true: map_in = dh, map_h = the
// forward's h, map_out = dx, map_da = da.
template <bool kReverse>
__global__ void __launch_bounds__(32)
scan_ring_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_in,
                 const __grid_constant__ CUtensorMap map_h,
                 const __grid_constant__ CUtensorMap map_out,
                 const __grid_constant__ CUtensorMap map_da, int T) {
  using R = Ring<kReverse>;
  extern __shared__ unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>((reinterpret_cast<uintptr_t>(smem_raw) + 127) &
                                         ~(uintptr_t)127);
  float* outs = ring + R::kStages * R::kIn * R::kTile;
  uint64_t* full = reinterpret_cast<uint64_t*>(outs + 2 * R::kOut * R::kTile);
  const int lane = threadIdx.x;
  const int w0 = blockIdx.x * kStrip;
  const int b = blockIdx.y;
  const int n_tiles = (T + kTileT - 1) / kTileT;

  // tile k of the walk starts at time step tile_t0(k)
  auto tile_t0 = [&](int k) { return (kReverse ? n_tiles - 1 - k : k) * kTileT; };
  auto fetch = [&](int k) {  // lane 0: tile k's inputs into stage k % kStages
    const int st = k % R::kStages;
    const int t0 = tile_t0(k);
    const uint32_t bar = smem_addr(&full[st]);
    float* dst = ring + st * R::kIn * R::kTile;
    mbar_expect_tx(bar, R::kIn * R::kTileBytes);
    tma_load_3d(smem_addr(dst), &map_a, bar, w0, t0, b);
    tma_load_3d(smem_addr(dst + R::kTile), &map_in, bar, w0, t0, b);
    if (kReverse) tma_load_3d(smem_addr(dst + 2 * R::kTile), &map_h, bar, w0, t0 - 1, b);
  };

  if (lane == 0) {
    for (int st = 0; st < R::kStages; ++st) mbar_init(smem_addr(&full[st]), 1);
    fence_barrier_init();
    for (int k = 0; k < min(R::kStages, n_tiles); ++k) fetch(k);
  }
  __syncwarp();

  float carry = 0.0f;   // h_{t-1} forward, g_{t+1} reverse
  float a_next = 0.0f;  // reverse: a_{t+1}, zero past the last step
  for (int k = 0; k < n_tiles; ++k) {
    const int st = k % R::kStages;
    const int t0 = tile_t0(k);
    mbar_wait(smem_addr(&full[st]), (k / R::kStages) & 1);
    if (lane == 0) bulk_wait_read_one();  // tile k - 2's store has left this buffer
    __syncwarp();
    const float* sa = ring + st * R::kIn * R::kTile + lane;
    const float* sin = sa + R::kTile;
    const float* sh = sa + 2 * R::kTile;
    float* so = outs + (k & 1) * R::kOut * R::kTile + lane;
    float* sda = so + R::kTile;
    // Every tile walks all kTileT steps: past T (and past W) TMA's zero
    // fill makes the extra steps give carry 0 (forward: the last tile;
    // reverse: the first, whose real steps then start from g = 0,
    // a_next = 0), and their outputs are clipped by the store.
    // Steps go through registers kU at a time, the next batch's loads
    // started before this batch's chain (the loads do not wait on the
    // chain's stores, which the compiler cannot tell apart from the
    // ring), so only the multiply and add are on the critical path.
    constexpr int kBatches = kTileT / kU;
    float ra[2][kU], rin[2][kU], rh[2][kU];
    auto load = [&](int bt, int buf) {
      const int u0 = kReverse ? kTileT - kU * (bt + 1) : kU * bt;
#pragma unroll
      for (int i = 0; i < kU; ++i) {
        ra[buf][i] = sa[(u0 + i) * kStrip];
        rin[buf][i] = sin[(u0 + i) * kStrip];
        if (kReverse) rh[buf][i] = sh[(u0 + i) * kStrip];
      }
    };
    load(0, 0);
#pragma unroll
    for (int bt = 0; bt < kBatches; ++bt) {
      const int buf = bt & 1;
      if (bt + 1 < kBatches) load(bt + 1, buf ^ 1);
      const int u0 = kReverse ? kTileT - kU * (bt + 1) : kU * bt;
#pragma unroll
      for (int j = 0; j < kU; ++j) {
        const int i = kReverse ? kU - 1 - j : j;
        carry = __fadd_rn(__fmul_rn(kReverse ? a_next : ra[buf][i], carry), rin[buf][i]);
        so[(u0 + i) * kStrip] = carry;
        if (kReverse) {
          sda[(u0 + i) * kStrip] = __fmul_rn(carry, rh[buf][i]);
          a_next = ra[buf][i];
        }
      }
    }
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) {
      float* ob = outs + (k & 1) * R::kOut * R::kTile;
      tma_store_3d(&map_out, smem_addr(ob), w0, t0, b);
      if (kReverse) tma_store_3d(&map_da, smem_addr(ob + R::kTile), w0, t0, b);
      bulk_commit();
      if (k + R::kStages < n_tiles) fetch(k + R::kStages);  // the stage just walked
    }
  }
  if (lane == 0) bulk_wait_all();
}

// 3-D f32 map of a contiguous (B, T, W) tensor, box (kStrip, kTileT, 1);
// out-of-range reads are zeros, out-of-range writes are dropped
static bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int B, int T, int W) {
  const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)W * 4, (cuuint64_t)T * W * 4};
  const cuuint32_t box[3] = {(cuuint32_t)kStrip, (cuuint32_t)kTileT, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ptrs: forward {a, x, h}; reverse {a, dh, h, dx, da}
template <bool kReverse>
static int launch(const void* const* ptrs, int B, int T, int W, cudaStream_t stream) {
  using R = Ring<kReverse>;
  if (B < 1 || T < 1 || W < 4 || W % 4) return (int)cudaErrorInvalidValue;
  EncodeTiled fn;
  cudaError_t err = get_encode_tiled(&fn);
  if (err != cudaSuccess) return (int)err;
  constexpr int kMaps = kReverse ? 5 : 3;
  CUtensorMap maps[kMaps];
  for (int i = 0; i < kMaps; ++i)
    if (!encode(fn, &maps[i], ptrs[i], B, T, W)) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(scan_ring_kernel<kReverse>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, R::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((W + kStrip - 1) / kStrip), (unsigned)B);
  if constexpr (kReverse)
    scan_ring_kernel<true><<<grid, 32, R::kSmem, stream>>>(maps[0], maps[1], maps[2], maps[3],
                                                          maps[4], T);
  else
    scan_ring_kernel<false><<<grid, 32, R::kSmem, stream>>>(maps[0], maps[1], maps[2], maps[2],
                                                           maps[2], T);
  return (int)cudaGetLastError();
}

}  // namespace scan_ring
}  // namespace repro_torch

// The ring kernels: all tensors (B,T,W) f32, contiguous, 16-byte aligned,
// on one device; W % 4 == 0; B <= 65535. Returns the error that kept the
// launch from happening, else cudaGetLastError().
extern "C" int repro_torch_rglru_scan_ring(const void* a, const void* x, void* h, int B, int T,
                                           int W, void* stream) {
  const void* ptrs[3] = {a, x, h};
  return repro_torch::scan_ring::launch<false>(ptrs, B, T, W, (cudaStream_t)stream);
}

extern "C" int repro_torch_rglru_scan_ring_bwd(const void* a, const void* h, const void* dh,
                                               void* dx, void* da, int B, int T, int W,
                                               void* stream) {
  const void* ptrs[5] = {a, dh, h, dx, da};
  return repro_torch::scan_ring::launch<true>(ptrs, B, T, W, (cudaStream_t)stream);
}
