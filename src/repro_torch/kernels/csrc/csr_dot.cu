// csr_dot: batch sparse inner products over padded CSR rows,
//   out[b] = sum_k values[b,k] * w[indices[b,k]].
//
// Replaces the Pallas TPU kernel src/repro/kernels/csr_dot.py (csr_dot,
// pallas_call at :88), the margins / objective / prediction step of the
// sparse-SVM DCD path (svm/dcd.py margins_csr). The TPU kernel keeps all
// of w in VMEM (:94) and streams the rows' (index, value) blocks past it.
//
// What bounds it on an H100: bytes. Each (index, value) pair is read
// once (8 B) for 2 FLOPs, and each id gathers one f32 of w. At the SVM
// path's shape, 10,000 rows of K = 5,456, the stream is 436 MB, and the
// ~37 M gathers each cost a 32-byte sector of a 66 MB w, above the 50 MB
// L2. Read on the normal policy, the 436 MB evict w as they pass: the
// stream alone takes ~150 us, the rest is gathers that miss L2.
//
// Design: one warp a row, eight rows a block. Lane l walks k = l, l+32,
// ... so a warp's index and value loads are coalesced 128-byte lines;
// they go through the read-only path under an L2 evict-first policy
// (ld.global.nc.L2::cache_hint with a createpolicy policy), so the stream
// passes w by and more of w stays in L2. Each lane loads the indices and
// values of kUnroll entries, then issues all kUnroll gathers of w at once
// (__ldg, the normal policy); the row's last entries, fewer than a batch,
// one at a time. The policy lives in the kernel and changes no state a
// later kernel sees (a stream access-policy window would).
// At the SVM shape, staging the indices and values through a shared-memory
// ring (bulk copies on mbarriers, or cp.async) was slower than this loop,
// and gathering w on an evict-last policy gained nothing
// (tools/kernel_variants.py; PERF.md section 6).
//
// Order: lane l adds the products of k = l, l+32, ... left to right, one
// f32 partial a lane, then a fixed xor-shuffle fold (16, 8, 4, 2, 1) ends
// the row. __fmul_rn / __fadd_rn keep nvcc from contracting the product
// and the sum into an FMA, so the kernel rounds exactly as ref.csr_dot
// does (the products, then the K/32 lane-strided slices left to right,
// then the fold in halves): bit-exact against it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr int kRowsPerBlock = 8;  // one warp a row
constexpr int kUnroll = 12;       // gathers in flight a lane

__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

// read-only loads under an L2 cache policy
__device__ __forceinline__ float load_hinted(const float* p, uint64_t policy) {
  float v;
  asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;\n" : "=f"(v) : "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ int load_hinted(const int* p, uint64_t policy) {
  int v;
  asm("ld.global.nc.L2::cache_hint.s32 %0, [%1], %2;\n" : "=r"(v) : "l"(p), "l"(policy));
  return v;
}

// w's gathers: the read-only path, the normal L2 policy
__device__ __forceinline__ float gather_w(const float* p) { return __ldg(p); }

__global__ void __launch_bounds__(kRowsPerBlock * 32)
csr_dot_kernel(const int* __restrict__ indices, const float* __restrict__ values,
               const float* __restrict__ w, float* __restrict__ out, int n_rows, int k_len) {
  const int lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int* idx = indices + row * (long)k_len;
  const float* val = values + row * (long)k_len;
  const uint64_t stream = l2_evict_first();

  float acc = 0.0f;
  int k = lane;
  for (; k + 32 * (kUnroll - 1) < k_len; k += 32 * kUnroll) {
    int i[kUnroll];
    float v[kUnroll], g[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      i[u] = load_hinted(idx + k + 32 * u, stream);
      v[u] = load_hinted(val + k + 32 * u, stream);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) g[u] = gather_w(w + i[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc = __fadd_rn(acc, __fmul_rn(v[u], g[u]));
  }
  for (; k < k_len; k += 32)
    acc = __fadd_rn(acc, __fmul_rn(load_hinted(val + k, stream),
                                   gather_w(w + load_hinted(idx + k, stream))));

#pragma unroll
  for (int width = 16; width > 0; width >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, width));
  if (lane == 0) out[row] = acc;
}

}  // namespace repro_torch

// indices (B,K) int32, values (B,K) f32, w (D,) f32, out (B,) f32; all
// contiguous on one device, ids in [0, D); B >= 1. Returns cudaGetLastError().
extern "C" int repro_torch_csr_dot(const void* indices, const void* values,
                                   const void* w, void* out, int n_rows,
                                   int k_len, void* stream) {
  using namespace repro_torch;
  const dim3 grid((n_rows + kRowsPerBlock - 1) / kRowsPerBlock);
  csr_dot_kernel<<<grid, kRowsPerBlock * 32, 0, (cudaStream_t)stream>>>(
      (const int*)indices, (const float*)values, (const float*)w, (float*)out, n_rows, k_len);
  return (int)cudaGetLastError();
}
