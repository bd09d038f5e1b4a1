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
// 128 B features and 100 of 4 B labels) the work is 26 KB, some 8 ns at
// 3.35 TB/s: a launch costs far more than the copy, and what is left of
// the kernel's own time is the number of dependent DRAM round trips a
// block makes. At large B the copy runs at the memory rate when enough
// bytes are in flight on every SM.
//
// Design. Both kernels only move bytes, so one kernel serves f32, bf16
// and int32: the host picks the widest word (16, 4 or 2 bytes) that
// divides block_bytes and both pointers' alignment, and every offset is
// 64-bit (a 2 GiB table already passes 2^31 bytes).
// - batch_gather (gather_tables_kernel): one launch gathers the same ids
//   from up to kMaxTables tables (the DNN path's features and labels), each
//   with its own row bytes and word; the descriptors travel by value in
//   the launch's parameters (__grid_constant__), and each table owns a run
//   of the grid's blocks. Where the ids come from the host and B <=
//   kParamIds, the C entry copies them into the parameters too (the TPU
//   kernel's scalar prefetch into SMEM): a block's first load from device
//   memory is the row itself (its ids come through the constant cache),
//   and no host-to-device copy of the ids precedes the launch.
//   Ids on the device (or B above the cap, or a CUDA graph that must read
//   new ids at each replay) go to the instantiation that loads its own
//   ids, one coalesced load a block. Either way a block normalises its
//   ids once into shared memory, then its 256 threads copy its rows as
//   one flat run of words (the output block is contiguous), four words in
//   flight a thread, loads before stores. A block takes up to
//   kItemsPerCta words (at most 256 ids), and fewer where the table's ids
//   would leave an SM idle: at the bandwidth shape (8,192 rows of 2 KB)
//   that is 512 blocks, about four to an SM, 64 KB in flight on each; at
//   the DNN shape (B = 100) one id a block.
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
#include <climits>

#include "hopper_async.cuh"

namespace repro_torch {

constexpr int kGatherThreads = 256;             // batch_gather
constexpr int kGatherUnroll = 4;                // its words in flight a thread
constexpr int kItemsPerCta = 2048;              // its words a thread block
constexpr int kMaxIdsPerCta = 256;
constexpr int kMaxTables = 4;                   // tables a launch (ops._MAX_TABLES)
constexpr int kParamIds = 960;                  // host ids a launch (ops._PARAM_IDS)
constexpr int kDmaThreads = 128;                // batch_gather_dma, 4- and 2-byte words
constexpr int kBulkThreads = 32;                // batch_gather_dma, bulk copies
constexpr long long kChunkBytes = 16384;        // the largest stage
constexpr long long kRingBytes = 96 * 1024;     // two blocks' rings fit on one SM
constexpr long long kMaxDepth = 128;            // stages in flight (one mbarrier each)

// the index contract: a negative id wraps once, then clamps
__device__ __forceinline__ long long wrap_clamp(long long b, long long n_blocks) {
  if (b < 0) b += n_blocks;
  return b < 0 ? 0 : (b >= n_blocks ? n_blocks - 1 : b);
}

__device__ __forceinline__ long long block_of(const int* idx, long long i,
                                              long long n_blocks) {
  return wrap_clamp(idx[i], n_blocks);
}

// One table of a gather_tables_kernel launch, as the host fills it in:
// `words` of `word` bytes a block, `ids_per_cta` ids a thread block, and
// blocks first_cta .. of the grid.
struct TableSpan {
  const unsigned char* table;
  unsigned char* out;
  long long n_blocks;
  int words;
  int word;
  int ids_per_cta;
  int first_cta;
};

// The launch's parameters (kIds ids copied from the host, or kIds == 0 and
// `idx` on the device): at most 4 KB, the kernel parameter space.
template <int kIds>
struct TablesArgs {
  TableSpan t[kMaxTables];
  const int* idx;
  int n_tables;
  int n_idx;
  int ids[kIds > 0 ? kIds : 1];
};
static_assert(sizeof(TablesArgs<kParamIds>) <= 4096, "the ids must fit the parameter space");

// `rows` blocks of `words` words each, from the element offsets in `off`,
// into the contiguous output run `dst`: item t is word t % words of row
// t / words; kGatherUnroll items a thread in flight, loads before stores.
template <typename T>
__device__ __forceinline__ void copy_rows(const T* __restrict__ src, T* __restrict__ dst,
                                          const long long* off, int rows, int words) {
  const int items = rows * words;
  for (int t0 = threadIdx.x; t0 < items; t0 += kGatherUnroll * kGatherThreads) {
    T v[kGatherUnroll];
#pragma unroll
    for (int u = 0; u < kGatherUnroll; ++u) {
      const int t = t0 + u * kGatherThreads;
      if (t < items) {
        const int row = t / words;
        v[u] = src[off[row] + (t - row * words)];
      }
    }
#pragma unroll
    for (int u = 0; u < kGatherUnroll; ++u) {
      const int t = t0 + u * kGatherThreads;
      if (t < items) dst[t] = v[u];
    }
  }
}

template <int kIds>
__global__ void __launch_bounds__(kGatherThreads)
gather_tables_kernel(const __grid_constant__ TablesArgs<kIds> a) {
  __shared__ long long off[kMaxIdsPerCta];
  TableSpan s = a.t[0];  // this block's table (static offsets: no dependent loads)
#pragma unroll
  for (int k = 1; k < kMaxTables; ++k)
    if (k < a.n_tables && (int)blockIdx.x >= a.t[k].first_cta) s = a.t[k];
  const int i0 = ((int)blockIdx.x - s.first_cta) * s.ids_per_cta;
  const int rows = min(s.ids_per_cta, a.n_idx - i0);
  for (int r = threadIdx.x; r < rows; r += kGatherThreads) {
    int id;
    if constexpr (kIds > 0) {
      id = a.ids[i0 + r];
    } else {
      id = __ldg(a.idx + i0 + r);
    }
    off[r] = wrap_clamp(id, s.n_blocks) * s.words;
  }
  __syncthreads();
  const long long first = (long long)i0 * s.words;
  if (s.word == 16)
    copy_rows((const uint4*)s.table, (uint4*)s.out + first, off, rows, s.words);
  else if (s.word == 4)
    copy_rows((const uint32_t*)s.table, (uint32_t*)s.out + first, off, rows, s.words);
  else
    copy_rows((const uint16_t*)s.table, (uint16_t*)s.out + first, off, rows, s.words);
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

// One table of a batch_gather launch, as the caller passes it (ops.py's
// ctypes mirror is build.GatherTable): table (n_blocks * block_bytes
// bytes), out (n_idx * block_bytes bytes); block_bytes even, n_blocks >= 1.
struct GatherTable {
  const void* table;
  void* out;
  long long n_blocks;
  long long block_bytes;
};

namespace repro_torch {

// the current device's SM count (read once a device)
inline int sm_count() {
  static int sms[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 1;
  if (sms[dev] == 0) cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev] > 0 ? sms[dev] : 1;
}

// Fill the launch's table spans; returns the grid's block count, or 0
// where the call is out of the kernel's range. A table's ids go to
// thread blocks of at most kItemsPerCta words and kMaxIdsPerCta ids, and
// of fewer ids where that leaves an SM without a block: at the DNN path's
// B = 100, one id a block, every row its own SM's single round trip.
template <int kIds>
inline long long fill_spans(TablesArgs<kIds>& a, const GatherTable* tables, int n_tables,
                            long long n_idx) {
  if (n_tables < 1 || n_tables > kMaxTables || n_idx < 1 || n_idx > INT_MAX) return 0;
  const long long spread = (n_idx + sm_count() - 1) / sm_count();
  a.n_tables = n_tables;
  a.n_idx = (int)n_idx;
  long long ctas = 0;
  for (int k = 0; k < n_tables; ++k) {
    const GatherTable& g = tables[k];
    const int word = word_bytes(g.table, g.out, g.block_bytes);
    const long long words = g.block_bytes / word;
    if (words < 1 || words * kGatherThreads > INT_MAX || g.n_blocks < 1) return 0;
    const int per = (int)std::max<long long>(
        1, std::min<long long>({kMaxIdsPerCta, kItemsPerCta / words, spread}));
    a.t[k] = TableSpan{(const unsigned char*)g.table, (unsigned char*)g.out, g.n_blocks,
                       (int)words, word, per, (int)ctas};
    ctas += (n_idx + per - 1) / per;
    if (ctas > INT_MAX) return 0;
  }
  return ctas;
}

template <int kIds>
inline int launch_tables(const GatherTable* tables, int n_tables, const int* host_ids,
                         const int* idx, long long n_idx, void* stream) {
  TablesArgs<kIds> a{};
  const long long ctas = fill_spans(a, tables, n_tables, n_idx);
  if (ctas == 0) return (int)cudaErrorInvalidValue;
  a.idx = idx;
  if constexpr (kIds > 0) std::copy(host_ids, host_ids + n_idx, a.ids);
  gather_tables_kernel<kIds><<<(unsigned)ctas, kGatherThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

// batch_gather of the same n_idx ids from n_tables (1..kMaxTables) tables
// in one launch; idx (n_idx,) int32 on the device. Returns
// cudaGetLastError() (cudaErrorInvalidValue for a call out of range).
extern "C" int repro_torch_gather_tables(const GatherTable* tables, int n_tables, const void* idx,
                                         long long n_idx, void* stream) {
  using namespace repro_torch;
  return launch_tables<0>(tables, n_tables, nullptr, (const int*)idx, n_idx, stream);
}

// As repro_torch_gather_tables, the ids (n_idx <= kParamIds int32) in host
// memory: they are copied into the launch's parameters before it returns.
extern "C" int repro_torch_gather_tables_params(const GatherTable* tables, int n_tables,
                                                const void* ids, long long n_idx,
                                                void* stream) {
  using namespace repro_torch;
  if (n_idx > kParamIds) return (int)cudaErrorInvalidValue;
  return launch_tables<kParamIds>(tables, n_tables, (const int*)ids, nullptr, n_idx, stream);
}

// batch_gather_dma: table (n_blocks * block_bytes bytes), idx (n_idx,)
// int32, out (n_idx * block_bytes bytes); block_bytes even; n_blocks,
// n_idx >= 1; rows_per_step >= 1 indices per block. Returns
// cudaGetLastError().
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
