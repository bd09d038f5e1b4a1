// flash_attention: causal / non-causal GQA attention forward pass.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, pallas_call at :104), which computes
// layers/attention.py::full_attention on the prefill path.
//
// What bounds it on an H100: bytes. At the serving prefill shape
// (q (1,128,32,128), k/v (1,128,8,128), bf16) the pass reads 1.5 MB of
// q/k/v and writes 1 MB of output for ~0.14 GFLOP of causal work, far
// below the ~295 FLOP/byte the tensor cores need to be the limit.
//
// Design: one block per (b, head, tile of 16 query rows), 4 warps of 4
// rows each, a warp's rows stepped side by side. The block walks the key axis in tiles of 32 staged in shared
// memory as f32 (one key per lane for the scores, lane-owned head dims
// for P·V), loading the next tile while it computes on this one, and
// keeps the online-softmax (m, l, acc) in registers, so the (S, T) score
// matrix never reaches device memory. Key tiles past the
// block's last causal row are never loaded, and the ragged edges
// (S, T not multiples of the tiles) are masked here: the serve path's
// S is the prompt capacity, which can be any length. CUDA-core f32 math:
// this kernel serves f32 calls and the head dims and groups that
// flash_attention_wgmma.cu (bf16 on the tensor cores) does not take. Head
// dims up to 160 (stablelm-12b's), in the head-dim classes of
// attention_tile.cuh: D <= 128 runs the 128 class, 129..160 the 160 class.
#include "attention_tile.cuh"

namespace repro_torch {

template <typename T, int MaxD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int s_len,
                       int t_len, int n_heads, int n_kv_heads, int d_head,
                       int causal, float scale) {
  TileSmem<MaxD>& sm = tile_smem<MaxD>();
  auto& qs = sm.qs;
  auto& tile = sm.tile;

  const int q0 = blockIdx.x * kRowsQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (n_heads / n_kv_heads);
  const int warp = threadIdx.x >> 5;

  // the tile's query rows q[b, q0 + r, h, :]; rows past S are never read
  load_rows_f32(q + (((long)b * s_len + q0) * n_heads + h) * d_head,
                (long)n_heads * d_head, min(kRowsQ, s_len - q0), d_head,
                &qs[0][0], MaxD);

  const long row_stride = (long)n_kv_heads * d_head;
  const T* kb = k + ((long)b * t_len * n_kv_heads + kvh) * d_head;
  const T* vb = v + ((long)b * t_len * n_kv_heads + kvh) * d_head;

  RowState<MaxD> st[kRowsPerWarp];
  int limit[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    row_init(st[r]);
    const int s = q0 + warp * kRowsPerWarp + r;
    limit[r] = causal ? min(s, t_len - 1) : t_len - 1;  // rows past S: never emitted
  }
  const int last_row = min(q0 + kRowsQ, s_len) - 1;
  const int t_end = causal ? min(last_row, t_len - 1) : t_len - 1;

  TileLoader<T, MaxD> next;
  next.load(kb, vb, row_stride, 0, t_len, d_head);
  for (int t0 = 0; t0 <= t_end; t0 += kTileK) {
    next.store(d_head, tile);
    __syncthreads();
    if (t0 + kTileK <= t_end) {  // in flight while this tile is used
      next.load(kb, vb, row_stride, t0 + kTileK, t_len, d_head);
    }
    rows_step<T, kRowsPerWarp>(qs[warp * kRowsPerWarp], tile, d_head, t0,
                               limit, scale, st);
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int s = q0 + warp * kRowsPerWarp + r;
    if (s < s_len) {
      row_emit<T, MaxD>(st[r], d_head, o + (((long)b * s_len + s) * n_heads + h) * d_head);
    }
  }
}

template <typename T, int MaxD>
static int launch_class(const void* q, const void* k, const void* v, void* o,
                        int b, int s_len, int t_len, int n_heads,
                        int n_kv_heads, int d_head, int causal,
                        cudaStream_t stream) {
  const cudaError_t err = set_tile_smem<MaxD>(flash_attention_kernel<T, MaxD>);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s_len + kRowsQ - 1) / kRowsQ, n_heads, b);
  const float scale = 1.f / sqrtf((float)d_head);
  flash_attention_kernel<T, MaxD><<<grid, kThreads, sizeof(TileSmem<MaxD>), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), s_len, t_len, n_heads,
      n_kv_heads, d_head, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const void* q, const void* k, const void* v, void* o, int b,
                  int s_len, int t_len, int n_heads, int n_kv_heads,
                  int d_head, int causal, cudaStream_t stream) {
  if (d_head <= 128)
    return launch_class<T, 128>(q, k, v, o, b, s_len, t_len, n_heads,
                                n_kv_heads, d_head, causal, stream);
  if (d_head <= kMaxD)
    return launch_class<T, kMaxD>(q, k, v, o, b, s_len, t_len, n_heads,
                                  n_kv_heads, d_head, causal, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace repro_torch

// q (B,S,H,D), k/v (B,T,K,D), o (B,S,H,D), all contiguous; dtype 0 = f32,
// 1 = bf16. Returns cudaGetLastError() after the launch.
extern "C" int repro_torch_flash_attention(const void* q, const void* k,
                                           const void* v, void* o, int b,
                                           int s_len, int t_len, int n_heads,
                                           int n_kv_heads, int d_head,
                                           int causal, int dtype,
                                           void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro_torch::launch<float>(q, k, v, o, b, s_len, t_len, n_heads,
                                      n_kv_heads, d_head, causal, st);
  if (dtype == 1)
    return repro_torch::launch<__nv_bfloat16>(q, k, v, o, b, s_len, t_len,
                                              n_heads, n_kv_heads, d_head,
                                              causal, st);
  return (int)cudaErrorInvalidValue;
}
