// rglru_scan: the RG-LRU linear recurrence over (B, T, W) f32,
//   forward   h_t = a_t * h_{t-1} + x_t,              h_{-1} = 0,
//   backward  g_t = dh_t + a_{t+1} * g_{t+1},         g_T = 0, a_T = 0,
//             dx_t = g_t,  da_t = g_t * h_{t-1}.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py
// (rglru_scan, pallas_call at :58), which the RG-LRU layer's
// associative_scan computes on the JAX path (layers/rglru.py). The TPU
// kernel has no backward (JAX differentiates the scan); the backward is the
// same recurrence run from the last step to the first, so one kernel with a
// direction flag gives both passes, bound to autograd by ops.RGLRUScan.
//
// What bounds it on an H100: bytes. Each step is one multiply and one add
// per channel; the forward moves 12 bytes a step (a, x in; h out), the
// backward 20 (a, h, dh in; dx, da out). The time axis is a chain of
// dependent steps, and at the training path's shape (1, 4096, 2560) there
// are only B * W = 2560 channels, so the card holds one warp per 32
// channels and the scan is limited by how many loads each thread keeps in
// flight, not by the memory's rate.
//
// Design: one thread per (b, w) channel, walking time; 32 channels per
// block (80 blocks at W = 2560, spread over as many SMs). Neighbouring
// threads read neighbouring w, so each step's loads are one coalesced
// 128-byte line per warp. A thread loads the next kSteps steps' inputs
// into registers (all independent loads, in flight together), then runs
// them through the recurrence. Whole batches run unguarded on pointers
// that advance by a batch; only the last 1..kSteps steps test their bounds
// (guarding every batch, with 64-bit offsets recomputed per step, took
// 1.5-2.4 times as long on an H100 at the path's shape). The Pallas
// kernel carries h across time blocks in VMEM; here it stays in a register
// for the whole walk.
// __fmul_rn / __fadd_rn keep nvcc from contracting a step into an FMA, so
// both directions round as the plain versions in kernels/ref.py do (one
// multiply, then one add, per step): bit-exact against them. A chunked
// two-pass scan (more parallelism over T) would round differently; it is
// later work.
#include <cuda_runtime.h>

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
