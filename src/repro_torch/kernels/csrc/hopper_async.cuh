// Hopper (sm_90a) asynchronous-copy primitives shared by batch_gather.cu,
// flash_attention_wgmma.cu and rglru_scan.cu: mbarriers, bulk copies
// between device and shared memory (cp.async.bulk), TMA tensor loads and
// stores (cp.async.bulk.tensor) and the proxy fences between them. Every
// device function is one PTX instruction or a short loop around one; the
// one host function finds the tensor-map encoder for the TMA launchers.
//
// An mbarrier here is initialised with an arrival count of 1: the one
// thread that issues a copy arrives on it with the copy's byte count
// (arrive.expect_tx), the copy engine completes that count, and the
// barrier's phase flips. A slot used for the n-th time waits for parity
// n & 1.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: libcuda is not linked
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Make mbarrier inits (generic-proxy stores) visible to the copy engine.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Order this thread's generic-proxy writes to shared memory before the
// copy engine reads them (a bulk or TMA store started after a barrier).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// bytes (a multiple of 16; both addresses 16-byte aligned) from device
// memory to shared memory; completes `bytes` on the mbarrier
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// bytes from shared memory to device memory, in this thread's current
// bulk group (close it with bulk_commit)
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst), "r"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until none of this thread's bulk groups still reads shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Wait until this thread's bulk groups have at most one still reading
// shared memory.
__device__ __forceinline__ void bulk_wait_read_one() {
  asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
}

// Wait until all of this thread's bulk groups have completed their writes.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// TMA load of one box of a 3-D tensor map at (c0, c1, c2), innermost
// first; elements out of range (negative coordinates too) arrive as zeros
// and count toward the box's bytes on the mbarrier.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* tmap, uint32_t bar, int c0,
                                            int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(tmap), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// TMA store of one box from shared memory at (c0, c1, c2), in this
// thread's current bulk group; elements out of range are not written.
__device__ __forceinline__ void tma_store_3d(const void* tmap, uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.tile.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          tmap),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// TMA load of one box of a 4-D tensor map at coordinates (c0..c3),
// innermost first; completes the box's bytes on the mbarrier. Out-of-range
// elements of the box arrive as zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* tmap, uint32_t bar, int c0,
                                            int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(tmap), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// cuTensorMapEncodeTiled, looked up at run time through libcudart (so
// libcuda is not linked). The encoder needs the device's context current
// on the calling thread, which a thread that has made no runtime call yet
// (autograd runs the backward on its own) lacks: cudaSetDevice on the
// runtime's current device makes it current first (cudaFree(nullptr)
// would too, but is refused while a stream is captured into a CUDA
// graph). Sets *fn and returns cudaSuccess, or returns the error
// (cudaErrorSymbolNotFound where the driver has no encoder).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline cudaError_t get_encode_tiled(EncodeTiled* fn) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  static const EncodeTiled found = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &status);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &status);
#endif
    return e == cudaSuccess && status == cudaDriverEntryPointSuccess ? (EncodeTiled)p : nullptr;
  }();
  *fn = found;
  return found != nullptr ? cudaSuccess : cudaErrorSymbolNotFound;
}

}  // namespace repro_torch
