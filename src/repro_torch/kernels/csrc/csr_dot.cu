// csr_dot: batch sparse inner products over padded CSR rows,
//   out[b] = sum_k values[b,k] * w[indices[b,k]].
//
// Replaces the Pallas TPU kernel src/repro/kernels/csr_dot.py (csr_dot,
// pallas_call at :88), the margins / objective / prediction step of the
// sparse-SVM DCD path (svm/dcd.py margins_csr).
//
// What bounds it on an H100: bytes. Each (index, value) pair is read
// once (8 B) for 2 FLOPs, and each id gathers one f32 of w. The TPU
// kernel keeps all of w in VMEM; at webspam's width w is 66 MB, above
// the 50 MB L2, so the gathers come from device memory: every distinct
// id costs at least one 32-byte sector, about a third of them L2 misses.
//
// Design: one warp per row, eight rows per block. Lane l walks
// k = l, l+32, ... so the index and value loads of a warp are coalesced
// 128-byte lines; the w gathers go through the read-only cache (__ldg)
// and are issued four at a time per lane so their latencies overlap.
// Each lane keeps one f32 partial sum, and a fixed xor-shuffle fold
// (16, 8, 4, 2, 1) ends the row. __fmul_rn / __fadd_rn keep nvcc from
// contracting the product and the sum into an FMA, so the kernel rounds
// exactly as ref.csr_dot does (the products, then the K/32 lane-strided
// slices left to right, then the fold in halves): bit-exact against it.
// Shared-memory staging, cp.async and a sort of ids for locality are
// later work.
#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kRowsPerBlock = 8;
constexpr int kUnroll = 4;

__global__ void __launch_bounds__(kRowsPerBlock * 32)
csr_dot_kernel(const int* __restrict__ indices, const float* __restrict__ values,
               const float* __restrict__ w, float* __restrict__ out,
               int n_rows, int k_len) {
  const int lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int* idx = indices + row * (long)k_len;
  const float* val = values + row * (long)k_len;

  float acc = 0.0f;
  int k = lane;
  // kUnroll independent gathers in flight per lane; the adds stay in k order
  for (; k + 32 * (kUnroll - 1) < k_len; k += 32 * kUnroll) {
    int i[kUnroll];
    float v[kUnroll], g[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      i[u] = idx[k + 32 * u];
      v[u] = val[k + 32 * u];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) g[u] = __ldg(w + i[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc = __fadd_rn(acc, __fmul_rn(v[u], g[u]));
  }
  for (; k < k_len; k += 32) acc = __fadd_rn(acc, __fmul_rn(val[k], __ldg(w + idx[k])));

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
      (const int*)indices, (const float*)values, (const float*)w, (float*)out,
      n_rows, k_len);
  return (int)cudaGetLastError();
}
