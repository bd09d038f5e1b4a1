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
// 128 B) the work is 26 KB, some 8 ns at 3.35 TB/s, so a launch costs
// far more than the copy and what is left of the kernel's own time is
// the number of dependent DRAM round trips a block makes; at large B the
// copy runs at the memory rate when enough bytes are in flight.
//
// Design. Both kernels only move bytes, so one kernel serves f32, bf16
// and int32: the host picks the widest word (16, 4 or 2 bytes) that
// divides block_bytes and both pointers' alignment, and every offset is
// 64-bit (a 2 GiB table already passes 2^31 bytes).
// - batch_gather: a block of 256 threads is cut into groups of G threads
//   (G the power of two >= the block's word count, at most 256); group g
//   copies one index's block, each thread four words at a time with the
//   loads issued before the stores.
// - batch_gather_dma: one block takes rows_per_step indices and stages
//   their blocks through shared memory, cut into stages (one index's
//   block, or a chunk of at most 16 KB of it), in rounds of as many
//   stages as fit in 96 KB (at most 128): every stage of a round is in
//   flight at once, so at the DNN path's shape (8 rows of 128 B) a block
//   makes one DRAM round trip for its ids, one for its rows, then the
//   stores. (The Pallas kernel's two-slot VMEM ring allowed two loads in
//   flight; on this card that made 8 dependent round trips a block, each
//   behind two barriers.)
//   - 16-byte words (block_bytes % 16 == 0, both pointers 16-byte
//     aligned): one warp and bulk copies (cp.async.bulk), one slot and
//     one mbarrier a stage (expect_tx = the stage's bytes, parity flipping
//     each round); each lane loads the ids of its stages and issues their
//     loads, then waits for each and issues its bulk store; before the
//     next round refills the slots, each lane waits until its stores have
//     read them (wait_group.read 0). Issue is spread over the warp because
//     the copy engine and one thread's issue chain are the limits here:
//     lane 0 issuing every stage cost ~0.2 us a stage.
//   - 4- and 2-byte words (4-byte label rows, offset tables): 128
//     threads issue all of a round's stages at once, as cp.async (plain
//     loads for 2-byte words, which have no cp.async form), one commit
//     group, one wait and one barrier, then the stores.
//   The ragged last block takes only the indices that exist (the Pallas
//   kernel pads with id 0 and slices the padding off; the output is the
//   same).
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper_async.cuh"

namespace repro_torch {

constexpr int kGatherThreads = 256;
constexpr int kUnroll = 4;
constexpr int kDmaThreads = 128;                // batch_gather_dma, 4- and 2-byte words
constexpr int kBulkThreads = 32;                // batch_gather_dma, bulk copies
constexpr long long kChunkBytes = 16384;        // the largest stage
constexpr long long kRingBytes = 96 * 1024;     // two blocks' rings fit on one SM
constexpr long long kMaxDepth = 128;            // stages in flight (one mbarrier each)

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
struct Word<4> { using T = uint32_t; };
template <>
struct Word<2> { using T = uint16_t; };

// the stage geometry of both ring kernels: a stage is one index's block,
// or a chunk of at most kChunkBytes of it; slot = a stage's size
__host__ __device__ __forceinline__ long long slot_bytes(long long block_bytes) {
  return block_bytes < kChunkBytes ? block_bytes : kChunkBytes;
}

// 16-byte words: bulk copies, one warp. A round is up to `depth` stages
// (stage s of the block: row s / chunks, chunk s % chunks), one slot and
// one mbarrier each; lane l issues the loads of the round's stages l,
// l + 32, ..., then waits for each and issues its bulk store, so a
// round's copies go out from 32 threads at once. Before the next round
// reuses the slots, every lane waits until its stores have read them.
// Each slot is used once a round, so round r waits for parity r & 1.
__global__ void __launch_bounds__(kBulkThreads)
gather_bulk_kernel(const unsigned char* __restrict__ table, const int* __restrict__ idx,
                   unsigned char* __restrict__ out, long long n_blocks,
                   long long block_bytes, long long n_idx, int rows_per_step, int depth) {
  extern __shared__ __align__(128) unsigned char smem[];
  const long long slot = slot_bytes(block_bytes);
  const long long chunks = (block_bytes + slot - 1) / slot;
  const uint32_t ring = smem_addr(smem);
  const uint32_t bars = ring + (uint32_t)(depth * slot);  // depth mbarriers
  const long long first = (long long)blockIdx.x * rows_per_step;
  const long long n = min((long long)rows_per_step, n_idx - first) * chunks;
  const int lane = threadIdx.x;
  if (lane == 0) {
    for (int k = 0; k < depth; ++k) mbar_init(bars + 8 * k, 1);
    fence_barrier_init();
  }
  __syncwarp();
  uint32_t parity = 0;
  for (long long s0 = 0; s0 < n; s0 += depth, parity ^= 1) {
    const int stages = (int)min((long long)depth, n - s0);
    for (int k = lane; k < stages; k += kBulkThreads) {
      const long long s = s0 + k;
      const long long row = chunks == 1 ? s : s / chunks;
      const long long off = (s - row * chunks) * slot;
      const uint32_t len = (uint32_t)min(slot, block_bytes - off);
      mbar_expect_tx(bars + 8 * k, len);
      bulk_load(ring + k * (uint32_t)slot,
                table + block_of(idx, first + row, n_blocks) * block_bytes + off, len,
                bars + 8 * k);
    }
    for (int k = lane; k < stages; k += kBulkThreads) {
      const long long s = s0 + k;
      const long long row = chunks == 1 ? s : s / chunks;
      const long long off = (s - row * chunks) * slot;
      mbar_wait(bars + 8 * k, parity);
      bulk_store(out + (first + row) * block_bytes + off, ring + k * (uint32_t)slot,
                 (uint32_t)min(slot, block_bytes - off));
    }
    bulk_commit();
    bulk_wait_read();  // this lane's stores have read their slots
    __syncwarp();
  }
}

// 4- and 2-byte words: rounds of up to `depth` stages, each round's
// copies all issued before one wait and one barrier.
template <int kWord>
__global__ void __launch_bounds__(kDmaThreads)
gather_staged_kernel(const unsigned char* __restrict__ table, const int* __restrict__ idx,
                     unsigned char* __restrict__ out, long long n_blocks,
                     long long block_bytes, long long n_idx, int rows_per_step, int depth) {
  using T = typename Word<kWord>::T;
  extern __shared__ __align__(16) unsigned char ring[];
  const long long slot = slot_bytes(block_bytes);
  const int slot_words = (int)(slot / kWord);
  const int chunks = (int)((block_bytes + slot - 1) / slot);
  const long long first = (long long)blockIdx.x * rows_per_step;
  const int rows = (int)min((long long)rows_per_step, n_idx - first);
  // a round starts at chunk c0 of row row0; item i of the round is word
  // i % slot_words of the round's stage i / slot_words (32-bit math)
  for (int row0 = 0, c0 = 0; row0 < rows;) {
    int stages = 0;  // this round's: up to depth, and no further than the last row
    {
      long long left = (long long)(rows - row0) * chunks - c0;
      stages = (int)min((long long)depth, left);
    }
    const int items = stages * slot_words;
    for (int i = threadIdx.x; i < items; i += kDmaThreads) {
      const int t = c0 + i / slot_words;
      const int row = row0 + t / chunks;
      const long long off = (long long)(t % chunks) * slot + (long long)(i % slot_words) * kWord;
      if (off < block_bytes) {  // a block's last chunk may be short
        const unsigned char* src = table + block_of(idx, first + row, n_blocks) * block_bytes + off;
        unsigned char* dst = ring + (long long)i * kWord;
        if constexpr (kWord == 2) {
          *(uint16_t*)dst = *(const uint16_t*)src;
        } else {
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    for (int i = threadIdx.x; i < items; i += kDmaThreads) {
      const int t = c0 + i / slot_words;
      const int row = row0 + t / chunks;
      const long long off = (long long)(t % chunks) * slot + (long long)(i % slot_words) * kWord;
      if (off < block_bytes)
        *(T*)(out + (first + row) * block_bytes + off) = *(const T*)(ring + (long long)i * kWord);
    }
    __syncthreads();  // the ring is refilled by the next round
    row0 += (c0 + stages) / chunks;
    c0 = (c0 + stages) % chunks;
  }
}

// Dynamic shared memory above the default 48 KB needs the kernel's opt-in.
template <typename K>
inline cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
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
  const long long slot = slot_bytes(block_bytes);
  const long long chunks = (block_bytes + slot - 1) / slot;
  // the ring: as many stages as a block has, within kRingBytes and kMaxDepth
  long long depth = std::min<long long>(kMaxDepth, kRingBytes / slot);
  if (rows_per_step < depth && chunks < depth)
    depth = std::min<long long>(depth, rows_per_step * chunks);
  const dim3 grid((unsigned)((n_idx + rows_per_step - 1) / rows_per_step));
  const unsigned char* t = (const unsigned char*)table;
  unsigned char* o = (unsigned char*)out;
  const int* ids = (const int*)idx;
  cudaStream_t s = (cudaStream_t)stream;
  const int d = (int)depth;
  if (word == 16) {
    const int smem = (int)(depth * slot + depth * 8);
    cudaError_t err = allow_smem(gather_bulk_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    gather_bulk_kernel<<<grid, kBulkThreads, smem, s>>>(t, ids, o, n_blocks, block_bytes, n_idx,
                                                       rows_per_step, d);
  } else if (word == 4) {
    const int smem = (int)(depth * slot);
    cudaError_t err = allow_smem(gather_staged_kernel<4>, smem);
    if (err != cudaSuccess) return (int)err;
    gather_staged_kernel<4><<<grid, kDmaThreads, smem, s>>>(t, ids, o, n_blocks, block_bytes,
                                                           n_idx, rows_per_step, d);
  } else {
    const int smem = (int)(depth * slot);
    cudaError_t err = allow_smem(gather_staged_kernel<2>, smem);
    if (err != cudaSuccess) return (int)err;
    gather_staged_kernel<2><<<grid, kDmaThreads, smem, s>>>(t, ids, o, n_blocks, block_bytes,
                                                           n_idx, rows_per_step, d);
  }
  return (int)cudaGetLastError();
}
