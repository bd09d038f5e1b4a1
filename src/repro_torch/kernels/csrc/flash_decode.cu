// flash_decode: one-token GQA attention against a per-row KV cache, for
// the calls flash_decode_cluster.cu does not take (f32, and bf16 head dims
// it has no instantiation for; kernels/ops.py routes). Head dims up to 160
// (stablelm-12b's), in the head-dim classes of attention_tile.cuh.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py
// (flash_decode, pallas_call at :91), which computes
// layers/attention.py::decode_attention on the per-slot decode path.
//
// What bounds it on an H100: bytes. Each query row does 4·D FLOPs per
// cached position it reads 2·D values for, so the K/V cache stream is the
// whole cost; at the serving shape (q (8,32,128), caches (8,C,8,128),
// bf16) that is at most 4 KB per position per row.
//
// Design: one block per (b, kv head) holding that head's G = H/K query
// rows, so every cached K/V tile is read from device memory once and
// used by all G rows (G <= 16, one row per warp per pass). The block
// walks positions 0..min(cur[b], T-1) in tiles of 32 staged in shared
// memory as f32, loading the next tile while it computes on this one,
// with the online softmax in registers; positions past cur[b] are never
// loaded. cur[b] >= T is legal: the serve engine keeps
// advancing the positions of idle slots past the arena's end, and such a
// row attends the whole cache without reading past T. The T edge is
// masked here (the arena length prompt_capacity + gen is arbitrary).
// Each row's log-sum-exp m + log(l) goes to lse when it is not null: a
// cache split over ranks combines the ranks' partial outputs by it.
#include "attention_tile.cuh"

namespace repro_torch {

constexpr int kMaxGroup = kWarps * kRowsPerWarp;

template <typename T, int MaxD>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ cur,
                    T* __restrict__ o, float* __restrict__ lse, int t_len,
                    int n_heads, int n_kv_heads, int d_head, float scale) {
  TileSmem<MaxD>& sm = tile_smem<MaxD>();  // qs: kMaxGroup rows
  auto& qs = sm.qs;
  auto& tile = sm.tile;

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int group = n_heads / n_kv_heads;
  const int warp = threadIdx.x >> 5;

  // q[b, kvh * G + g, :] for the group's rows
  load_rows_f32(q + ((long)b * n_heads + (long)kvh * group) * d_head,
                d_head, group, d_head, &qs[0][0], MaxD);

  const int limit = min(cur[b], t_len - 1);
  const long row_stride = (long)n_kv_heads * d_head;
  const T* kb = k + ((long)b * t_len * n_kv_heads + kvh) * d_head;
  const T* vb = v + ((long)b * t_len * n_kv_heads + kvh) * d_head;

  RowState<MaxD> st[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) row_init(st[r]);

  TileLoader<T, MaxD> next;
  next.load(kb, vb, row_stride, 0, t_len, d_head);
  for (int t0 = 0; t0 <= limit; t0 += kTileK) {
    next.store(d_head, tile);
    __syncthreads();
    if (t0 + kTileK <= limit) {  // in flight while this tile is used
      next.load(kb, vb, row_stride, t0 + kTileK, t_len, d_head);
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int g = r * kWarps + warp;  // warp-uniform
      if (g < group) rows_step<T, 1, MaxD>(qs[g], tile, d_head, t0, &limit, scale, &st[r]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int g = r * kWarps + warp;
    if (g < group) {
      const long row = (long)b * n_heads + (long)kvh * group + g;
      row_emit<T, MaxD>(st[r], d_head, o + row * d_head);
      if (lse != nullptr && (threadIdx.x & 31) == 0) lse[row] = st[r].m + logf(fmaxf(st[r].l, 1e-30f));
    }
  }
}

template <typename T, int MaxD>
static int launch_class(const void* q, const void* k, const void* v,
                        const int* cur, void* o, float* lse, int b, int t_len,
                        int n_heads, int n_kv_heads, int d_head, cudaStream_t stream) {
  const cudaError_t err = set_tile_smem<MaxD>(flash_decode_kernel<T, MaxD>);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_kv_heads, b);
  const float scale = 1.f / sqrtf((float)d_head);
  flash_decode_kernel<T, MaxD><<<grid, kThreads, sizeof(TileSmem<MaxD>), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), cur, static_cast<T*>(o), lse, t_len, n_heads,
      n_kv_heads, d_head, scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const void* q, const void* k, const void* v, const int* cur,
                  void* o, float* lse, int b, int t_len, int n_heads, int n_kv_heads,
                  int d_head, cudaStream_t stream) {
  if (d_head <= 128)
    return launch_class<T, 128>(q, k, v, cur, o, lse, b, t_len, n_heads, n_kv_heads,
                                d_head, stream);
  if (d_head <= kMaxD)
    return launch_class<T, kMaxD>(q, k, v, cur, o, lse, b, t_len, n_heads,
                                  n_kv_heads, d_head, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace repro_torch

// q (B,H,D), k/v caches (B,T,K,D), cur (B,) int32, o (B,H,D), all
// contiguous; lse (B,H) f32 or null; dtype 0 = f32, 1 = bf16. Returns
// cudaGetLastError().
extern "C" int repro_torch_flash_decode(const void* q, const void* k,
                                        const void* v, const void* cur,
                                        void* o, void* lse, int b, int t_len,
                                        int n_heads, int n_kv_heads, int d_head,
                                        int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const int* c = static_cast<const int*>(cur);
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return repro_torch::launch<float>(q, k, v, c, o, l, b, t_len, n_heads,
                                      n_kv_heads, d_head, st);
  if (dtype == 1)
    return repro_torch::launch<__nv_bfloat16>(q, k, v, c, o, l, b, t_len, n_heads,
                                              n_kv_heads, d_head, st);
  return (int)cudaErrorInvalidValue;
}
