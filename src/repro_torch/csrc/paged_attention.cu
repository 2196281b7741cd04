// Paged attention straight from the K/V block pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py::
// paged_attention_pool (Pallas; bodies _paged_kernel / _paged_kernel_loop
// sharing the online-softmax step _accumulate). Same contract: q
// (b, sq, hq, hd); K/V pools (n_blocks, block_size, h_kv, hd); per-row block
// tables (b, n_tbl) int32 with -1 = unallocated (clamped to block 0 and
// masked); per-row kv_offset / kv_len / q_lens (b,) int32. Masks: causal
// kpos <= kv_offset + q_index, kpos < kv_len, q_index < q_len, sliding
// window kpos > qpos - window. Fully masked query rows produce zeros. The
// g query heads of a K/V head are packed as rows, row = head_in_group * sq
// + q_index (the reference's packing). fp32 softmax with the reference's
// guards (NEG_INF = -1e30, m_safe, alpha; out = acc / max(l, 1e-30)); the
// output in q's dtype.
//
// Two variants; the wrapper picks one from dtype, sq and head_dim alone.
//
// split-KV (decode and short rows; every fp32 call). A decode step does
// 2 * g FLOPs per K/V element it reads (32 per element on chatglm3-6b), far
// below the H100's ~295 FLOPs/byte ridge: its floor is the live K/V bytes
// over 3.35 TB/s, a few microseconds. What held the first version back was
// latency: one block per (row, kv head) walked every live page in order,
// 4 blocks on 132 SMs, each page staged synchronously between barriers.
// This design
//   * adds a grid axis over contiguous ranges of table entries (splits):
//     grid (n_splits, h_kv * row_tiles, b), the plan a function of n_tbl,
//     block_size, sq and g only (never of kv_len's values: no host sync).
//     A split past its row's kv_len, or wholly before the window, writes
//     an empty partial (m = NEG_INF, l = 0) and exits;
//   * stages 32-key chunks (one key per lane, 32 / block_size pages) with
//     cp.async into a 3-deep ring: two chunks are in flight while one is
//     scored, and one barrier per chunk orders the ring;
//   * keeps 16 packed query rows per block (4 warps x 4 rows) with q in
//     shared memory as fp32, scores on the CUDA cores in fp32 (the fp32
//     pools' 2e-5 tolerance rules out TF32), P through a per-warp shared
//     slab into P V, where each lane owns 4 head dims;
//   * writes fp32 (m, l, acc) partials; a small combine kernel on the same
//     stream merges them into out (exact 0 for rows whose every split is
//     empty). A single split normalizes and writes out itself.
//
// append tensor-core tile (bf16 chunks of sq >= 4). A chunk of sq tokens
// does sq times a decode step's work per K/V byte and is bound by
// operations; the first version ran it on the CUDA cores and re-read every
// live page once per 16 packed rows. Here a block owns 64 packed rows of
// one K/V head (16 per warp); each 64-key chunk of pages is staged by
// cp.async into a double-buffered ring and feeds S = Q K^T and O += P V
// through mma.sync m16n8k16 (attention_tile.cuh), P staying in registers as
// the A fragments. Q waits in the ring's second stage until it is in
// registers (70 KB of shared memory a block). Chunks above every row's causal
// limit (or before every row's window) are never loaded, and a warp skips
// the chunks its own rows cannot see. Few row tiles (a short chunk over a
// long cache) would leave most SMs idle while each block walks the whole
// cache, so the same split axis applies: the blocks of a split write
// partials for the combine kernel. wgmma and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "attention_tile.cuh"

namespace {

using attn::kNegInf;
using bf16 = __nv_bfloat16;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) {
  return __bfloat162float(x);
}

// 16 bytes of T -> fp32: 4 floats or 8 bf16 values
__device__ __forceinline__ void unpack16(const float* src, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}
__device__ __forceinline__ void unpack16(const bf16* src, float* dst) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// 4 consecutive elements of T <-> fp32
__device__ __forceinline__ void load4(const float* src, float* dst) {
  unpack16(src, dst);
}
__device__ __forceinline__ void load4(const bf16* src, float* dst) {
  const uint2 v = *reinterpret_cast<const uint2*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  dst[0] = a.x;
  dst[1] = a.y;
  dst[2] = b.x;
  dst[3] = b.y;
}
__device__ __forceinline__ void store4(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(bf16* dst, const float* v) {
  uint2 w;
  w.x = attn::pack_bf16(v[0], v[1]);
  w.y = attn::pack_bf16(v[2], v[3]);
  *reinterpret_cast<uint2*>(dst) = w;
}

// --------------------------------------------------------------- split-KV

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // packed query rows per block
constexpr int kChunk = 32;                    // keys per staged chunk
constexpr int kStages = 3;                    // chunks in the cp.async ring

template <typename T>
size_t split_smem_bytes(int hd) {
  const size_t row = (size_t)hd * sizeof(T) + 16;  // padded K / V row
  return kStages * 2 * kChunk * row + (size_t)kRows * hd * sizeof(float) +
         (size_t)kWarps * kChunk * kRowsPerWarp * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
split_kv_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                const T* __restrict__ v_pool, const int* __restrict__ tables,
                const int* __restrict__ kv_offset,
                const int* __restrict__ kv_len,
                const int* __restrict__ q_lens, T* __restrict__ out,
                float* __restrict__ part_acc, float2* __restrict__ part_ml,
                int sq, int hq, int hkv, int hd, int bs_shift, int n_tbl,
                int pages_per_split, int causal, int window, float scale) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte copy
  extern __shared__ uint4 smem_u4[];
  const int bs = 1 << bs_shift;
  const int row_bytes = hd * (int)sizeof(T) + 16;
  const int stage_bytes = 2 * kChunk * row_bytes;
  char* ring = reinterpret_cast<char*>(smem_u4);
  float* q_s = reinterpret_cast<float*>(ring + kStages * stage_bytes);
  float* p_w = q_s + kRows * hd + (threadIdx.x / 32) * kChunk * kRowsPerWarp;

  const int split = blockIdx.x;
  const int n_splits = gridDim.x;
  const int row_tiles = gridDim.y / hkv;
  const int ih = blockIdx.y / row_tiles;
  const int tile = blockIdx.y - ih * row_tiles;
  const int ib = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = hq / hkv;
  const int rows_real = g * sq;
  const int off = kv_offset[ib];
  const int kv_end = min(kv_len[ib], n_tbl << bs_shift);
  const int q_len = q_lens[ib];

  // this warp's rows: [lo, hi) of attendable keys; hi <= lo masks the row
  int lo[kRowsPerWarp], hi[kRowsPerWarp], row_of[kRowsPerWarp];
  size_t base[kRowsPerWarp];  // element offset of the row's q / out head
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = tile * kRows + warp * kRowsPerWarp + r;
    const bool real = row < rows_real;
    const int ig = real ? row / sq : 0;
    const int qi = real ? row - ig * sq : 0;
    const int qpos = off + qi;
    row_of[r] = real ? row : -1;
    base[r] = ((size_t)(ib * sq + qi) * hq + (size_t)ih * g + ig) * hd;
    hi[r] = (real && qi < q_len) ? (causal ? min(kv_end, qpos + 1) : kv_end)
                                 : 0;
    lo[r] = window > 0 ? qpos - window + 1 : 0;
  }

  // the keys any row of the block can attend, within this split
  const int r_first = tile * kRows;
  const int r_last = min(r_first + kRows, rows_real) - 1;
  int q_min = 0, q_max = sq - 1;
  if (r_first / sq == r_last / sq) {
    q_min = r_first % sq;
    q_max = r_last % sq;
  }
  q_max = min(q_max, q_len - 1);
  const int blk_hi = q_max < q_min
                         ? 0
                         : (causal ? min(kv_end, off + q_max + 1) : kv_end);
  const int blk_lo = window > 0 ? max(0, off + q_min - window + 1) : 0;
  const int s_lo = split * pages_per_split << bs_shift;
  const int s_hi = min((split + 1) * pages_per_split, n_tbl) << bs_shift;
  const int k_begin = s_lo + (max(blk_lo, s_lo) - s_lo) / kChunk * kChunk;
  const int k_end = min(blk_hi, s_hi);
  const int n_chunks = k_end > k_begin ? (k_end - k_begin + kChunk - 1) / kChunk
                                       : 0;
  const int vecs = hd / kVec;  // 16-byte copies per K / V row

  auto load_chunk = [&](int c) {
    char* st = ring + (c % kStages) * stage_bytes;
    const int kc = k_begin + c * kChunk;
    for (int i = threadIdx.x; i < kChunk * vecs; i += blockDim.x) {
      const int j = i / vecs;
      const int v = i - j * vecs;
      const int key = kc + j;
      const bool ok = key < kv_end;
      size_t src = 0;
      if (ok) {
        const int phys = max(tables[(size_t)ib * n_tbl + (key >> bs_shift)], 0);
        src = (((size_t)phys * bs + (key & (bs - 1))) * hkv + ih) * hd +
              (size_t)v * kVec;
      }
      attn::cp_async16(st + j * row_bytes + v * 16, k_pool + src, ok);
      attn::cp_async16(st + (kChunk + j) * row_bytes + v * 16, v_pool + src,
                       ok);
    }
  };

  float acc[kRowsPerWarp][4], m[kRowsPerWarp], l[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;
  }
  const bool owns_dims = 4 * lane < hd;

  if (n_chunks > 0) load_chunk(0);
  attn::cp_async_commit();
  if (n_chunks > 1) load_chunk(1);
  attn::cp_async_commit();
  // q rows as fp32, while the first chunks are in flight
  if (n_chunks > 0) {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
      for (int d = lane; d < hd; d += 32)
        q_s[(warp * kRowsPerWarp + r) * hd + d] =
            row_of[r] >= 0 ? to_float(q[base[r] + d]) : 0.f;
  }
  for (int c = 0; c < n_chunks; ++c) {
    attn::cp_async_wait<1>();  // chunk c has landed (c + 1 may be in flight)
    __syncthreads();           // ... for every thread; chunk c - 1 is done
    if (c + 2 < n_chunks) load_chunk(c + 2);
    attn::cp_async_commit();

    const char* st = ring + (c % kStages) * stage_bytes;
    // scores: this lane's key against the warp's rows, over all of hd
    const T* krow = reinterpret_cast<const T*>(st + lane * row_bytes);
    float s[kRowsPerWarp] = {};
#pragma unroll 2
    for (int v = 0; v < vecs; ++v) {
      float kf[kVec];
      unpack16(krow + v * kVec, kf);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float* qr = q_s + (warp * kRowsPerWarp + r) * hd + v * kVec;
#pragma unroll
        for (int e = 0; e < kVec; e += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qr + e);
          s[r] = fmaf(qv.x, kf[e], s[r]);
          s[r] = fmaf(qv.y, kf[e + 1], s[r]);
          s[r] = fmaf(qv.z, kf[e + 2], s[r]);
          s[r] = fmaf(qv.w, kf[e + 3], s[r]);
        }
      }
    }
    // the reference's online-softmax step, one key per lane
    const int key = k_begin + c * kChunk + lane;
    float p[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const bool ok = key >= lo[r] && key < hi[r];
      const float sc = ok ? s[r] * scale : kNegInf;
      float mx = sc;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float m_new = fmaxf(m[r], mx);
      const float m_safe = m_new <= kNegInf ? 0.f : m_new;
      p[r] = ok ? expf(sc - m_safe) : 0.f;
      const float alpha = m[r] <= kNegInf ? 0.f : expf(m[r] - m_safe);
      float ps = p[r];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ps += __shfl_xor_sync(kFull, ps, o);
      l[r] = l[r] * alpha + ps;
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][e] *= alpha;
    }
    *reinterpret_cast<float4*>(p_w + lane * kRowsPerWarp) =
        make_float4(p[0], p[1], p[2], p[3]);
    __syncwarp();
    // acc += P V: lane owns head dims 4 lane .. 4 lane + 3
    if (owns_dims) {
      const char* vs = st + kChunk * row_bytes;
#pragma unroll 4
      for (int j = 0; j < kChunk; ++j) {
        const float4 pj = *reinterpret_cast<const float4*>(p_w + j * 4);
        float vv[4];
        load4(reinterpret_cast<const T*>(vs + j * row_bytes) + 4 * lane, vv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[0][e] = fmaf(pj.x, vv[e], acc[0][e]);
          acc[1][e] = fmaf(pj.y, vv[e], acc[1][e]);
          acc[2][e] = fmaf(pj.z, vv[e], acc[2][e]);
          acc[3][e] = fmaf(pj.w, vv[e], acc[3][e]);
        }
      }
    }
    __syncwarp();  // P is read before the next chunk overwrites it
  }
  attn::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    if (row_of[r] < 0) continue;
    if (part_acc != nullptr) {  // partial of this split, combined later
      const size_t idx =
          ((size_t)(ib * hkv + ih) * rows_real + row_of[r]) * n_splits + split;
      if (lane == 0) part_ml[idx] = make_float2(m[r], l[r]);
      if (owns_dims && n_chunks > 0)
        store4(part_acc + idx * hd + 4 * lane, acc[r]);
    } else if (owns_dims) {  // the only split: normalize and write out
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      float o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) o[e] = acc[r][e] * inv;
      store4(out + base[r] + 4 * lane, o);
    }
  }
}

// merge the splits' (m, l, acc) partials of each packed row into out; a
// warp per row, each lane 4 head dims. Lane j reads split j's (m, l) (32
// splits a pass), the weights exp(m - max m) reach every lane by shuffle,
// and the acc loads of a pass are independent of each other. Empty splits
// (m = NEG_INF) get weight 0 and their acc is never read, so a row whose
// every split is empty gives exactly 0.
template <typename T>
__global__ void __launch_bounds__(128)
combine_kernel(const float* __restrict__ part_acc,
               const float2* __restrict__ part_ml, T* __restrict__ out,
               int n_rows, int sq, int hq, int hkv, int hd, int n_splits) {
  const int gw = blockIdx.x * 4 + threadIdx.x / 32;  // (ib, ih, row)
  const int lane = threadIdx.x % 32;
  if (gw >= n_rows) return;
  const int g = hq / hkv;
  const int rows_real = g * sq;
  const int row = gw % rows_real;
  const int bh = gw / rows_real;
  const int ih = bh % hkv;
  const int ib = bh / hkv;
  const int ig = row / sq;
  const int qi = row - ig * sq;
  const float2* ml = part_ml + (size_t)gw * n_splits;
  const float* acc_row = part_acc + (size_t)gw * n_splits * hd + 4 * lane;
  float mx = kNegInf;
  for (int s = lane; s < n_splits; s += 32) mx = fmaxf(mx, ml[s].x);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float sum = 0.f;
  const bool owns_dims = 4 * lane < hd;
  if (mx > kNegInf) {
    for (int s0 = 0; s0 < n_splits; s0 += 32) {
      float w = 0.f;
      if (s0 + lane < n_splits) {
        const float2 v = ml[s0 + lane];
        if (v.x > kNegInf) {  // else an empty split
          w = expf(v.x - mx);
          sum += w * v.y;
        }
      }
      const int n = min(32, n_splits - s0);
#pragma unroll 8
      for (int j = 0; j < n; ++j) {
        const float wj = __shfl_sync(kFull, w, j);
        if (wj != 0.f && owns_dims) {
          const float4 a = *reinterpret_cast<const float4*>(
              acc_row + (size_t)(s0 + j) * hd);
          acc[0] = fmaf(wj, a.x, acc[0]);
          acc[1] = fmaf(wj, a.y, acc[1]);
          acc[2] = fmaf(wj, a.z, acc[2]);
          acc[3] = fmaf(wj, a.w, acc[3]);
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
  }
  if (!owns_dims) return;
  const float inv = 1.f / fmaxf(sum, 1e-30f);
  float o[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) o[e] = acc[e] * inv;
  store4(out + ((size_t)(ib * sq + qi) * hq + (size_t)ih * g + ig) * hd +
             4 * lane,
         o);
}

template <typename T>
int launch_combine(void* part_acc, void* part_ml, void* out, int b, int sq,
                   int hq, int hkv, int hd, int n_splits,
                   cudaStream_t stream);

template <typename T>
int launch_split(const void* q, const void* k_pool, const void* v_pool,
                 const void* tables, const void* kv_offset,
                 const void* kv_len, const void* q_lens, void* out,
                 void* part_acc, void* part_ml, int b, int sq, int hq,
                 int hkv, int hd, int bs_shift, int n_tbl,
                 int pages_per_split, int n_splits, int causal, int window,
                 float scale, cudaStream_t stream) {
  const int rows = (hq / hkv) * sq;
  const int row_tiles = (rows + kRows - 1) / kRows;
  const size_t smem = split_smem_bytes<T>(hd);
  cudaError_t err = cudaFuncSetAttribute(
      split_kv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool combine = n_splits > 1;
  split_kv_kernel<T><<<dim3(n_splits, hkv * row_tiles, b), kWarps * 32, smem,
                       stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(kv_offset), static_cast<const int*>(kv_len),
      static_cast<const int*>(q_lens), static_cast<T*>(out),
      combine ? static_cast<float*>(part_acc) : nullptr,
      static_cast<float2*>(part_ml), sq, hq, hkv, hd, bs_shift, n_tbl,
      pages_per_split, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || !combine) return static_cast<int>(err);
  return launch_combine<T>(part_acc, part_ml, out, b, sq, hq, hkv, hd,
                           n_splits, stream);
}

// ------------------------------------------------- append tensor-core tile

constexpr int kTileWarps = 4;
constexpr int kTileMinBlocks = 2;  // resident blocks per SM (register cap)
constexpr int kTileRows = 16 * kTileWarps;  // packed query rows per block
constexpr int kTileKeys = 64;               // keys per staged chunk
constexpr float kLn2 = 0.6931471805599453f;

template <int HD>
constexpr size_t append_smem_bytes() {  // 2 x (K, V); Q lives in stage 1
  static_assert(kTileRows <= 2 * kTileKeys, "Q fits stage 1");
  return (size_t)4 * kTileKeys * (HD + 8) * sizeof(bf16);
}

template <int HD>
__global__ void __launch_bounds__(kTileWarps * 32, kTileMinBlocks)
append_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_pool,
                  const bf16* __restrict__ v_pool,
                  const int* __restrict__ tables,
                  const int* __restrict__ kv_offset,
                  const int* __restrict__ kv_len,
                  const int* __restrict__ q_lens, bf16* __restrict__ out,
                  float* __restrict__ part_acc, float2* __restrict__ part_ml,
                  int sq, int hq, int hkv, int bs_shift, int n_tbl,
                  int pages_per_split, int n_splits, int causal, int window,
                  float scale_log2) {
  constexpr int kStride = HD + 8;
  constexpr int kTile = kTileKeys * kStride;  // one K or V chunk
  constexpr int kVecs = HD / 8;               // 16-byte copies per row
  extern __shared__ uint4 smem_u4[];
  // stage s: K at 2 s kTile, V next. Q is staged in stage 1 and moves to
  // registers before the ring first refills it.
  bf16* kv_s = reinterpret_cast<bf16*>(smem_u4);
  bf16* q_s = kv_s + 2 * kTile;
  __shared__ int blk_range[2];

  const int tile = blockIdx.x / n_splits;
  const int split = blockIdx.x - tile * n_splits;
  const int ih = blockIdx.y;
  const int ib = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int bs = 1 << bs_shift;
  const int g = hq / hkv;
  const int rows_real = g * sq;
  const int off = kv_offset[ib];
  const int kv_end = min(kv_len[ib], n_tbl << bs_shift);
  const int q_len = q_lens[ib];

  // Q rows of this tile (rows past the packing zero-filled)
  for (int i = threadIdx.x; i < kTileRows * kVecs; i += blockDim.x) {
    const int r = i / kVecs;
    const int v = i - r * kVecs;
    const int row = tile * kTileRows + r;
    const bool ok = row < rows_real;
    const int ig = ok ? row / sq : 0;
    const int qi = ok ? row - ig * sq : 0;
    attn::cp_async16(
        q_s + r * kStride + v * 8,
        q + ((size_t)(ib * sq + qi) * hq + (size_t)ih * g + ig) * HD + v * 8,
        ok);
  }

  // this lane's rows g and g + 8 of its warp: keys lo .. hi (inclusive)
  int lo[2], hi[2], row_of[2];
  size_t base[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = tile * kTileRows + warp * 16 + (lane >> 2) + 8 * rr;
    const bool real = row < rows_real;
    const int ig = real ? row / sq : 0;
    const int qi = real ? row - ig * sq : 0;
    const int qpos = off + qi;
    row_of[rr] = real ? row : -1;
    base[rr] = ((size_t)(ib * sq + qi) * hq + (size_t)ih * g + ig) * HD;
    hi[rr] = (real && qi < q_len) ? (causal ? min(qpos, kv_end - 1)
                                            : kv_end - 1)
                                  : -1;
    lo[rr] = window > 0 ? max(qpos - window + 1, 0) : 0;
  }
  // the keys each warp, and the whole block, can attend
  const bool live0 = hi[0] >= lo[0], live1 = hi[1] >= lo[1];
  const int my_lo = min(live0 ? lo[0] : INT_MAX, live1 ? lo[1] : INT_MAX);
  const int my_hi = max(live0 ? hi[0] : -1, live1 ? hi[1] : -1);
  const int warp_lo = __reduce_min_sync(kFull, my_lo);
  const int warp_hi = __reduce_max_sync(kFull, my_hi);
  if (threadIdx.x == 0) {
    blk_range[0] = INT_MAX;
    blk_range[1] = -1;
  }
  __syncthreads();
  if (lane == 0) {
    atomicMin(&blk_range[0], warp_lo);
    atomicMax(&blk_range[1], warp_hi);
  }
  __syncthreads();
  // ... within this split's table entries (whole chunks)
  const int split_keys = pages_per_split << bs_shift;
  const int s_end = min((split + 1) * pages_per_split, n_tbl) << bs_shift;
  int c_begin = 0, c_end = 0;
  if (blk_range[1] >= blk_range[0]) {
    c_begin = max(blk_range[0], split * split_keys) / kTileKeys;
    c_end = (min(blk_range[1] + 1, s_end) + kTileKeys - 1) / kTileKeys;
  }

  auto load_chunk = [&](int c) {
    bf16* k_dst = kv_s + ((c - c_begin) & 1) * 2 * kTile;
    bf16* v_dst = k_dst + kTile;
    for (int i = threadIdx.x; i < kTileKeys * kVecs; i += blockDim.x) {
      const int j = i / kVecs;
      const int v = i - j * kVecs;
      const int key = c * kTileKeys + j;
      const bool ok = key < kv_end;
      size_t src = 0;
      if (ok) {
        const int phys = max(tables[(size_t)ib * n_tbl + (key >> bs_shift)], 0);
        src = (((size_t)phys * bs + (key & (bs - 1))) * hkv + ih) * HD + v * 8;
      }
      attn::cp_async16(k_dst + j * kStride + v * 8, k_pool + src, ok);
      attn::cp_async16(v_dst + j * kStride + v * 8, v_pool + src, ok);
    }
  };

  if (c_begin < c_end) load_chunk(c_begin);
  attn::cp_async_commit();

  attn::RowState<HD> st;
  st.init();
  uint32_t qf[HD / 16][4];
  for (int c = c_begin; c < c_end; ++c) {
    attn::cp_async_wait<0>();  // chunk c (and, first, Q) has landed
    __syncthreads();           // ... for every thread; chunk c - 1 is done
    if (c == c_begin) {
      attn::load_q_fragments<HD>(qf, q_s, kStride, warp * 16);
      __syncthreads();  // Q is in registers: stage 1 may refill
    }
    if (c + 1 < c_end) load_chunk(c + 1);
    attn::cp_async_commit();
    const int k0 = c * kTileKeys;
    if (warp_hi < k0 || warp_lo >= k0 + kTileKeys) continue;  // warp-uniform
    const bf16* k_s = kv_s + ((c - c_begin) & 1) * 2 * kTile;
    attn::attend_tile<HD, kTileKeys>(qf, k_s, k_s + kTile, kStride, k0, lo,
                                     hi, scale_log2, st);
  }
  attn::cp_async_wait<0>();

  const int t = lane & 3;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (row_of[rr] < 0) continue;
    if (part_acc != nullptr) {  // partial of this split, combined later
      const size_t idx =
          ((size_t)(ib * hkv + ih) * rows_real + row_of[rr]) * n_splits +
          split;
      if (t == 0)  // the running max back in natural-log units
        part_ml[idx] = make_float2(
            st.m[rr] <= kNegInf ? kNegInf : st.m[rr] * kLn2, st.l[rr]);
      if (c_begin < c_end) {
#pragma unroll
        for (int i = 0; i < HD / 8; ++i)
          *reinterpret_cast<float2*>(part_acc + idx * HD + i * 8 + 2 * t) =
              make_float2(st.acc[i][2 * rr], st.acc[i][2 * rr + 1]);
      }
      continue;
    }
    const float inv = st.inv_l(rr);
    bf16* o = out + base[rr];
#pragma unroll
    for (int i = 0; i < HD / 8; ++i)
      *reinterpret_cast<uint32_t*>(o + i * 8 + 2 * t) = attn::pack_bf16(
          st.acc[i][2 * rr] * inv, st.acc[i][2 * rr + 1] * inv);
  }
}

template <typename T>
int launch_combine(void* part_acc, void* part_ml, void* out, int b, int sq,
                   int hq, int hkv, int hd, int n_splits,
                   cudaStream_t stream) {
  const int n_rows = b * hkv * (hq / hkv) * sq;
  combine_kernel<T><<<(n_rows + 3) / 4, 128, 0, stream>>>(
      static_cast<const float*>(part_acc),
      static_cast<const float2*>(part_ml), static_cast<T*>(out), n_rows, sq,
      hq, hkv, hd, n_splits);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_append(const void* q, const void* k_pool, const void* v_pool,
                  const void* tables, const void* kv_offset,
                  const void* kv_len, const void* q_lens, void* out,
                  void* part_acc, void* part_ml, int b, int sq, int hq,
                  int hkv, int bs_shift, int n_tbl, int pages_per_split,
                  int n_splits, int causal, int window, float scale,
                  cudaStream_t stream) {
  const size_t smem = append_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      append_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = (hq / hkv) * sq;
  const bool combine = n_splits > 1;
  const dim3 grid((rows + kTileRows - 1) / kTileRows * n_splits, hkv, b);
  append_mma_kernel<HD><<<grid, kTileWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_pool),
      static_cast<const bf16*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(kv_offset), static_cast<const int*>(kv_len),
      static_cast<const int*>(q_lens), static_cast<bf16*>(out),
      combine ? static_cast<float*>(part_acc) : nullptr,
      static_cast<float2*>(part_ml), sq, hq, hkv, bs_shift, n_tbl,
      pages_per_split, n_splits, causal, window, scale * attn::kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess || !combine) return static_cast<int>(err);
  return launch_combine<bf16>(part_acc, part_ml, out, b, sq, hq, hkv, HD,
                              n_splits, stream);
}

}  // namespace

// Plain C entry for ctypes. The caller (kernels/paged_attention.py) checks
// shapes, dtypes, devices and contiguity, picks the variant (0 split-KV,
// 1 append tensor-core tile) and its split plan, allocates ``out`` and,
// with more than one split, the fp32 partials (``part_acc`` (b, hkv, g sq,
// n_splits, hd), ``part_ml`` (b, hkv, g sq, n_splits, 2)), and passes
// PyTorch's current stream. Returns the first CUDA error of the launches
// (cudaGetLastError() after each), 0 on success.
extern "C" int paged_attention_fwd(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* kv_offset, const void* kv_len, const void* q_lens, void* out,
    void* part_acc, void* part_ml, int b, int sq, int hq, int hkv, int hd,
    int bs, int n_tbl, int causal, int window, int is_bf16, int variant,
    int pages_per_split, int n_splits, float scale, void* stream) {
  int bs_shift = 0;
  while ((1 << bs_shift) < bs) ++bs_shift;
  if ((1 << bs_shift) != bs || bs < 4 || bs > kChunk || n_splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    if (!is_bf16 || (pages_per_split * bs) % kTileKeys)
      return static_cast<int>(cudaErrorInvalidValue);
#define PAGED_APPEND_LAUNCH(HD_)                                              \
  return launch_append<HD_>(q, k_pool, v_pool, tables, kv_offset, kv_len,     \
                            q_lens, out, part_acc, part_ml, b, sq, hq, hkv,   \
                            bs_shift, n_tbl, pages_per_split, n_splits,       \
                            causal, window, scale, st)
    switch (hd) {
      case 16: PAGED_APPEND_LAUNCH(16);
      case 32: PAGED_APPEND_LAUNCH(32);
      case 64: PAGED_APPEND_LAUNCH(64);
      case 128: PAGED_APPEND_LAUNCH(128);
    }
#undef PAGED_APPEND_LAUNCH
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (variant != 0 || hd > 4 * 32 || hd % 4 ||
      (pages_per_split * bs) % kChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16)
    return launch_split<bf16>(q, k_pool, v_pool, tables, kv_offset, kv_len,
                              q_lens, out, part_acc, part_ml, b, sq, hq, hkv,
                              hd, bs_shift, n_tbl, pages_per_split, n_splits,
                              causal, window, scale, st);
  return launch_split<float>(q, k_pool, v_pool, tables, kv_offset, kv_len,
                             q_lens, out, part_acc, part_ml, b, sq, hq, hkv,
                             hd, bs_shift, n_tbl, pages_per_split, n_splits,
                             causal, window, scale, st);
}
