// batch_gather / batch_gather_dma: the LIRS gather. For each of B block
// ids, copy the r consecutive table rows of block idx[i] (block_bytes =
// r * D * element size bytes) into output block i:
//   out[i*r : (i+1)*r, :] = table[idx[i]*r : (idx[i]+1)*r, :].
//
// Replaces the Pallas TPU kernels src/repro/kernels/batch_gather.py
// batch_gather (pallas_call at :63; one grid step per index, the block
// DMA'd into VMEM by a scalar-prefetched index map) and batch_gather_dma
// (pallas_call at :144; rows_per_step indices per grid step through a
// two-slot VMEM ring with DMA semaphores).
//
// Index contract (that of batch_gather_ref and of the Pallas kernels in
// interpret mode): a negative id has n_blocks added once, then the id is
// clamped to [0, n_blocks - 1]. No thread reads outside the table.
//
// What bounds it on an H100: bytes, 2 * block_bytes per index plus the
// 4-byte id, and no arithmetic. At the DNN path's shape (100 rows of
// 128 B) the work is 26 KB, some 8 ns at 3.35 TB/s, so one launch costs
// far more than the copy; at large B the copy runs at the memory rate
// when every thread moves 16-byte words with several loads in flight.
//
// Design. Both kernels only move bytes, so one kernel serves f32, bf16
// and int32: the host picks the widest word (16, 4 or 2 bytes) that
// divides block_bytes and both pointers' alignment, and every offset is
// 64-bit (a 2 GiB table already passes 2^31 bytes).
// - batch_gather: a block of 256 threads is cut into groups of G threads
//   (G the power of two >= the block's word count, at most 256); group g
//   copies one index's block, each thread four words at a time with the
//   loads issued before the stores.
// - batch_gather_dma: one block of 128 threads takes rows_per_step
//   indices and streams their blocks, cut into chunks of at most 16 KB,
//   through two shared-memory slots with cp.async: the load of chunk s+1
//   is in flight while chunk s is written out. The ragged last block
//   takes only the indices that exist (the Pallas kernel pads with id 0
//   and slices the padding off; the output is the same). A 2-byte word
//   has no cp.async form: then each chunk is staged by plain loads.
// TMA bulk copies and a persistent grid are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr int kGatherThreads = 256;
constexpr int kUnroll = 4;
constexpr int kDmaThreads = 128;
constexpr long long kChunkBytes = 16384;  // one ring slot

__device__ __forceinline__ long long block_of(const int* idx, long long i,
                                              long long n_blocks) {
  long long b = idx[i];
  if (b < 0) b += n_blocks;
  return b < 0 ? 0 : (b >= n_blocks ? n_blocks - 1 : b);
}

template <typename T>
__global__ void __launch_bounds__(kGatherThreads)
gather_kernel(const T* __restrict__ table, const int* __restrict__ idx,
              T* __restrict__ out, long long n_blocks, long long words,
              int group, long long n_idx) {
  const long long i = (long long)blockIdx.x * (kGatherThreads / group) + threadIdx.x / group;
  if (i >= n_idx) return;
  const T* src = table + block_of(idx, i, n_blocks) * words;
  T* dst = out + i * words;
  for (long long j = threadIdx.x % group; j < words; j += (long long)kUnroll * group) {
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (j + u * group < words) v[u] = src[j + u * group];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (j + u * group < words) dst[j + u * group] = v[u];
  }
}

template <int kWord>
struct Word;
template <>
struct Word<16> { using T = uint4; };
template <>
struct Word<4> { using T = uint32_t; };
template <>
struct Word<2> { using T = uint16_t; };

// stage `bytes` bytes from global to shared, kWord at a time
template <int kWord>
__device__ __forceinline__ void stage(unsigned char* smem, const unsigned char* src,
                                      long long bytes) {
  for (long long o = (long long)threadIdx.x * kWord; o < bytes; o += (long long)kDmaThreads * kWord) {
    if constexpr (kWord == 2) {
      *(uint16_t*)(smem + o) = *(const uint16_t*)(src + o);
    } else {
      const unsigned s = (unsigned)__cvta_generic_to_shared(smem + o);
      if constexpr (kWord == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src + o));
      else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src + o));
    }
  }
  // one group per stage, empty where this thread had nothing to copy
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kWord>
__global__ void __launch_bounds__(kDmaThreads)
gather_dma_kernel(const unsigned char* __restrict__ table, const int* __restrict__ idx,
                  unsigned char* __restrict__ out, long long n_blocks,
                  long long block_bytes, long long n_idx, int rows_per_step) {
  using T = typename Word<kWord>::T;
  extern __shared__ __align__(16) unsigned char ring[];
  const long long slot = block_bytes < kChunkBytes ? block_bytes : kChunkBytes;
  const long long first = (long long)blockIdx.x * rows_per_step;
  const long long rows = min((long long)rows_per_step, n_idx - first);
  const long long chunks = (block_bytes + slot - 1) / slot;
  const long long stages = rows * chunks;

  // stage s = (index first + s / chunks, chunk s % chunks)
  auto src_of = [&](long long s, long long* len) {
    const long long c = s % chunks;
    *len = min(slot, block_bytes - c * slot);
    return table + block_of(idx, first + s / chunks, n_blocks) * block_bytes + c * slot;
  };

  long long len;
  const unsigned char* src = src_of(0, &len);
  stage<kWord>(ring, src, len);
  for (long long s = 0; s < stages; ++s) {
    unsigned char* cur = ring + (s & 1) * slot;
    const long long cur_len = len;
    if (s + 1 < stages) {
      src = src_of(s + 1, &len);
      stage<kWord>(ring + ((s + 1) & 1) * slot, src, len);
    } else {
      asm volatile("cp.async.commit_group;\n" ::);
    }
    asm volatile("cp.async.wait_group 1;\n" ::);  // stage s has landed
    __syncthreads();
    unsigned char* dst = out + (first + s / chunks) * block_bytes + (s % chunks) * slot;
    for (long long o = (long long)threadIdx.x * kWord; o < cur_len; o += (long long)kDmaThreads * kWord)
      *(T*)(dst + o) = *(const T*)(cur + o);
    __syncthreads();  // slot s & 1 is refilled by stage s + 2
  }
}

// the widest word that divides the block and both pointers' alignment
inline int word_bytes(const void* table, const void* out, long long block_bytes) {
  const uintptr_t bits = (uintptr_t)table | (uintptr_t)out | (uintptr_t)block_bytes;
  return bits % 16 == 0 ? 16 : (bits % 4 == 0 ? 4 : 2);
}

}  // namespace repro_torch

// table (n_blocks * block_bytes bytes), idx (n_idx,) int32, out (n_idx *
// block_bytes bytes); block_bytes even; n_blocks, n_idx >= 1. Returns
// cudaGetLastError().
extern "C" int repro_torch_batch_gather(const void* table, const void* idx, void* out,
                                        long long n_blocks, long long block_bytes,
                                        long long n_idx, void* stream) {
  using namespace repro_torch;
  const int word = word_bytes(table, out, block_bytes);
  const long long words = block_bytes / word;
  int group = 1;
  while (group < words && group < kGatherThreads) group <<= 1;
  const long long per_block = kGatherThreads / group;
  const dim3 grid((unsigned)((n_idx + per_block - 1) / per_block));
  cudaStream_t s = (cudaStream_t)stream;
  if (word == 16)
    gather_kernel<uint4><<<grid, kGatherThreads, 0, s>>>(
        (const uint4*)table, (const int*)idx, (uint4*)out, n_blocks, words, group, n_idx);
  else if (word == 4)
    gather_kernel<uint32_t><<<grid, kGatherThreads, 0, s>>>(
        (const uint32_t*)table, (const int*)idx, (uint32_t*)out, n_blocks, words, group, n_idx);
  else
    gather_kernel<uint16_t><<<grid, kGatherThreads, 0, s>>>(
        (const uint16_t*)table, (const int*)idx, (uint16_t*)out, n_blocks, words, group, n_idx);
  return (int)cudaGetLastError();
}

// As repro_torch_batch_gather, rows_per_step >= 1 indices per block.
extern "C" int repro_torch_batch_gather_dma(const void* table, const void* idx, void* out,
                                            long long n_blocks, long long block_bytes,
                                            long long n_idx, int rows_per_step,
                                            void* stream) {
  using namespace repro_torch;
  const int word = word_bytes(table, out, block_bytes);
  const long long slot = block_bytes < kChunkBytes ? block_bytes : kChunkBytes;
  const size_t smem = (size_t)(2 * ((slot + 15) / 16 * 16));
  const dim3 grid((unsigned)((n_idx + rows_per_step - 1) / rows_per_step));
  const unsigned char* t = (const unsigned char*)table;
  unsigned char* o = (unsigned char*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (word == 16)
    gather_dma_kernel<16><<<grid, kDmaThreads, smem, s>>>(
        t, (const int*)idx, o, n_blocks, block_bytes, n_idx, rows_per_step);
  else if (word == 4)
    gather_dma_kernel<4><<<grid, kDmaThreads, smem, s>>>(
        t, (const int*)idx, o, n_blocks, block_bytes, n_idx, rows_per_step);
  else
    gather_dma_kernel<2><<<grid, kDmaThreads, smem, s>>>(
        t, (const int*)idx, o, n_blocks, block_bytes, n_idx, rows_per_step);
  return (int)cudaGetLastError();
}
