// Online-softmax tile step shared by flash_attention.cu and flash_decode.cu.
//
// Both kernels stage one tile of kTileK keys (and values) of a single KV
// head in shared memory as f32, then let each warp advance the running
// (m, l, acc) statistics of its query rows over that tile:
//
//   lane j scores key t0 + j against the row's query (f32 dot over D),
//   masked keys (t > limit) score -1e30 (never -inf: a fully masked row
//   must still give a finite output), the row max / sum are warp
//   reductions, and p is rounded to the value dtype before the P·V
//   product, exactly as the TPU kernels cast p to v's dtype.
//
// The TPU kernels keep the same statistics in VMEM scratch across a
// sequential grid axis; here the key loop runs inside one block. Tiles
// move from device memory in 16-byte vectors, every thread's loads of a
// tile issued together, and the next tile's loads are in flight while
// the block computes on the current one (TileLoader), so a tile costs
// about one memory latency, not one per element.
//
// Everything sized by the head dim is a template on its class MaxD, the
// largest D a class takes: 128 (D <= 128) or 160 (stablelm-12b's head
// dim). A call runs the smallest class that holds its D, so the D <= 128
// calls keep their register and load layout. The block's shared memory
// (TileSmem: 16 query rows and a K/V tile, f32) is dynamic: 41,088 bytes
// at 128, 51,328 at 160, above the 48 KB a static array may take.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kMaxD = 160;             // largest head dim the kernels take
constexpr int kTileK = 32;             // keys per staged tile: one per lane
constexpr int kWarps = 4;              // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;        // query rows a warp carries
constexpr int kRowsQ = kWarps * kRowsPerWarp;  // query rows a block stages
constexpr int kStaticSmem = 48 * 1024; // above it, shared memory must be opted into
constexpr float kNegInf = -1e30f;      // the TPU kernels' mask value
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFullMask, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

// 16 bytes of T: 8 bf16 or 4 f32. The wrappers require D to be a multiple
// of 8 and every base pointer to be 16-byte aligned.
template <typename T>
struct Vec {
  static constexpr int kElems = 16 / sizeof(T);
};

// Unpack one 16-byte vector of T into f32 and store it at dst (shared).
__device__ __forceinline__ void unpack_store(const uint4& raw, float* dst, float) {
  dst[0] = __uint_as_float(raw.x);
  dst[1] = __uint_as_float(raw.y);
  dst[2] = __uint_as_float(raw.z);
  dst[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack_store(const uint4& raw, float* dst, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// Copy n_rows rows of d_head values (row r at src + r * row_stride, T)
// into dst[r][.] (f32, shared, row pitch `pitch` floats).
template <typename T>
__device__ __forceinline__ void load_rows_f32(const T* __restrict__ src,
                                              long row_stride, int n_rows,
                                              int d_head, float* dst,
                                              int pitch) {
  constexpr int kE = Vec<T>::kElems;
  const int per_row = d_head / kE;
  for (int i = threadIdx.x; i < n_rows * per_row; i += blockDim.x) {
    const int r = i / per_row;
    const int c = (i - r * per_row) * kE;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
    unpack_store(raw, dst + r * pitch + c, T());
  }
}

// Shared-memory tile of one KV head. K rows are padded by one float so
// that lane j reading ks[j][d] hits bank (j + d) % 32: no conflicts.
template <int MaxD>
struct KVTile {
  float ks[kTileK][MaxD + 1];
  float vs[kTileK][MaxD];
};

// A block's shared memory: its query rows (f32, pitch MaxD) and the tile.
template <int MaxD>
struct TileSmem {
  float qs[kRowsQ][MaxD];
  KVTile<MaxD> tile;
};

template <int MaxD>
__device__ __forceinline__ TileSmem<MaxD>& tile_smem() {
  extern __shared__ __align__(16) unsigned char tile_smem_raw[];
  return *reinterpret_cast<TileSmem<MaxD>*>(tile_smem_raw);
}

// Opt a kernel into its TileSmem where that exceeds the static limit.
template <int MaxD, typename Kernel>
__host__ __forceinline__ cudaError_t set_tile_smem(Kernel kernel) {
  if (sizeof(TileSmem<MaxD>) <= kStaticSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)sizeof(TileSmem<MaxD>));
}

// Register staging of one K/V tile: each thread owns up to kSlots
// 16-byte vectors of K and of V. load() issues all of a thread's loads
// back to back (positions at or past t_len read as zero); store() writes
// them to shared memory after the previous tile's readers are done.
template <typename T, int MaxD>
struct TileLoader {
  static constexpr int kE = Vec<T>::kElems;
  static constexpr int kSlots = kTileK * MaxD / kE / kThreads;
  uint4 k[kSlots];
  uint4 v[kSlots];

  __device__ __forceinline__ void load(const T* __restrict__ kb,
                                       const T* __restrict__ vb,
                                       long row_stride, int t0, int t_len,
                                       int d_head) {
    const int per_row = d_head / kE;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int i = threadIdx.x + s * kThreads;
      const int j = i / per_row;
      const int t = t0 + j;
      k[s] = make_uint4(0, 0, 0, 0);
      v[s] = make_uint4(0, 0, 0, 0);
      if (j < kTileK && t < t_len) {
        const long off = (long)t * row_stride + (i - j * per_row) * kE;
        k[s] = *reinterpret_cast<const uint4*>(kb + off);
        v[s] = *reinterpret_cast<const uint4*>(vb + off);
      }
    }
  }

  __device__ __forceinline__ void store(int d_head, KVTile<MaxD>& tile) const {
    const int per_row = d_head / kE;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int i = threadIdx.x + s * kThreads;
      const int j = i / per_row;
      if (j < kTileK) {
        const int c = (i - j * per_row) * kE;
        unpack_store(k[s], &tile.ks[j][c], T());
        unpack_store(v[s], &tile.vs[j][c], T());
      }
    }
  }
};

template <int MaxD>
struct RowState {
  static constexpr int kDimsPerLane = MaxD / 32;
  float m;
  float l;
  float acc[kDimsPerLane];  // lane owns dims lane + 32 * i
};

template <int MaxD>
__device__ __forceinline__ void row_init(RowState<MaxD>& st) {
  st.m = kNegInf;
  st.l = 0.f;
#pragma unroll
  for (int i = 0; i < RowState<MaxD>::kDimsPerLane; ++i) st.acc[i] = 0.f;
}

// Advance R query rows (f32, shared, pitch MaxD, starting at q_first)
// over a staged tile. Called by a whole warp (the shuffles need every
// lane); row r masks keys past limit[r]. The rows run side by side, so
// each K and V value read from shared memory serves all R rows and the
// FMA chains are independent. A row whose keys are all masked in this
// tile is left exactly as it was (p = 0, corr = 1), provided it saw an
// unmasked key before, as every real row does at key 0. d_head is a
// multiple of 8.
template <typename T, int R, int MaxD>
__device__ __forceinline__ void rows_step(const float* __restrict__ q_first,
                                          const KVTile<MaxD>& tile, int d_head,
                                          int t0, const int* limit,
                                          float scale, RowState<MaxD>* st) {
  constexpr int kDimsPerLane = RowState<MaxD>::kDimsPerLane;
  const int lane = threadIdx.x & 31;
  // four partial sums per row: independent chains instead of one of D
  float acc4[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int u = 0; u < 4; ++u) acc4[r][u] = 0.f;
  }
  const float* krow = tile.ks[lane];
  for (int d = 0; d < d_head; d += 4) {
    const float k0 = krow[d], k1 = krow[d + 1], k2 = krow[d + 2], k3 = krow[d + 3];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 q4 = *reinterpret_cast<const float4*>(q_first + r * MaxD + d);
      acc4[r][0] = fmaf(q4.x, k0, acc4[r][0]);
      acc4[r][1] = fmaf(q4.y, k1, acc4[r][1]);
      acc4[r][2] = fmaf(q4.z, k2, acc4[r][2]);
      acc4[r][3] = fmaf(q4.w, k3, acc4[r][3]);
    }
  }
  float p_v[R], corr[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float s = ((acc4[r][0] + acc4[r][1]) + (acc4[r][2] + acc4[r][3])) * scale;
    if (t0 + lane > limit[r]) s = kNegInf;
    const float m_new = fmaxf(st[r].m, warp_max(s));
    const float p = expf(s - m_new);
    corr[r] = expf(st[r].m - m_new);
    st[r].l = st[r].l * corr[r] + warp_sum(p);
    st[r].m = m_new;
    p_v[r] = to_f32(from_f32<T>(p));  // p cast to v's dtype
  }
  float pv[R][kDimsPerLane];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) pv[r][i] = 0.f;
  }
#pragma unroll 4
  for (int j = 0; j < kTileK; ++j) {
    float pj[R];
#pragma unroll
    for (int r = 0; r < R; ++r) pj[r] = __shfl_sync(kFullMask, p_v[r], j);
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < d_head) {
        const float vx = tile.vs[j][d];
#pragma unroll
        for (int r = 0; r < R; ++r) pv[r][i] = fmaf(pj[r], vx, pv[r][i]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) {
      st[r].acc[i] = st[r].acc[i] * corr[r] + pv[r][i];
    }
  }
}

// Write acc / max(l, 1e-30) for one row; out points at the row's D values.
template <typename T, int MaxD>
__device__ __forceinline__ void row_emit(const RowState<MaxD>& st, int d_head,
                                         T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const float l = fmaxf(st.l, 1e-30f);
#pragma unroll
  for (int i = 0; i < RowState<MaxD>::kDimsPerLane; ++i) {
    const int d = lane + 32 * i;
    if (d < d_head) out[d] = from_f32<T>(st.acc[i] / l);
  }
}

}  // namespace repro_torch
