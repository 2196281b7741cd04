// Paged attention straight from the K/V block pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py::
// paged_attention_pool (Pallas; bodies _paged_kernel / _paged_kernel_loop
// sharing the online-softmax step _accumulate). Same contract: q
// (b, sq, hq, hd); K/V pools (n_blocks, block_size, h_kv, hd); per-row block
// tables (b, n_tbl) int32 with -1 = unallocated (clamped to block 0 and
// masked); per-row kv_offset / kv_len / q_lens (b,) int32. Masks: causal
// kpos <= kv_offset + q_index, kpos < kv_len, q_index < q_len, sliding
// window kpos > qpos - window. Fully masked query rows produce zeros.
//
// What bounds it on this card: the K/V bytes. A decode step does 2 * g
// FLOPs per K/V element it reads (the g query heads of a GQA group share one
// K/V head: 32 FLOPs per element, 16 per bf16 byte, on chatglm3-6b), far
// below the H100's ~295 FLOPs/byte ridge, so the time floor is live K/V
// bytes / 3.35 TB/s. (Append chunks of c tokens do c times as much per
// byte and turn bound by operations once c * 16 passes the ridge.) The
// design therefore
//   * reads only live table entries: the loop runs from the window's first
//     live entry to ceil(kv_len / block_size), never over the table width;
//   * reads each live block once per tile of kRows packed query rows: the g
//     query heads of one K/V head are packed as rows (row = head_in_group *
//     sq + q_index, the reference's packing), so a decode step (g = 16 on
//     chatglm3-6b) streams each K/V block exactly once per (row, kv head);
//   * never materializes the gathered (b, n_tbl * block_size) view.
// Grid (b, h_kv, ceil(g * sq / kRows)); 4 warps of kRowsPerWarp rows each.
// A block stages one physical (block_size, hd) K and V tile in shared memory
// (fp32, 16-byte loads) and each warp runs the reference's _accumulate step
// for its rows. Scores: one key per lane (block_size 4, 8, 16 or 32, a
// template argument), the head dim split over the 32 / block_size lanes
// that share a key (K tile rows padded so those reads
// hit distinct banks; q read from shared memory as a broadcast), the warp's
// rows interleaved so their dependency chains overlap. Max and sum reduce
// over the key lanes once per row and tile. The accumulator keeps one head
// dim slice per lane (hd <= 128). fp32 math, NEG_INF = -1e30 and the same
// m_safe / alpha guards as the reference; out = acc / max(l, 1e-30) in q's
// dtype. wgmma, TMA, split-KV and cp.async double buffering are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // packed query rows per block
constexpr int kDimsPerLane = 4;               // head_dim <= 32 * 4
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of T -> fp32: 4 floats or 8 bf16 values
__device__ __forceinline__ void unpack16(const float* src, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}
__device__ __forceinline__ void unpack16(const __nv_bfloat16* src,
                                         float* dst) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

template <typename T, int BS>
__global__ void __launch_bounds__(kWarps * 32)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int* __restrict__ tables,
                       const int* __restrict__ kv_offset,
                       const int* __restrict__ kv_len,
                       const int* __restrict__ q_lens, T* __restrict__ out,
                       int sq, int hq, int hkv, int hd, int n_tbl,
                       int causal, int window, float scale) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  // the kParts = 32 / BS lanes sharing a key split its head dims; K rows
  // are padded to a stride == kParts (mod 32) so their reads hit 32
  // distinct banks. BS is a template argument so the key loops unroll.
  constexpr int kParts = 32 / BS;
  const int k_stride = hd + ((kParts - hd) % 32 + 32) % 32;
  extern __shared__ float smem[];
  float* k_s = smem;                   // (BS, k_stride) fp32 K tile
  float* v_s = k_s + BS * k_stride;    // (BS, hd) fp32 V tile
  float* q_s = v_s + BS * hd;          // (kRows, hd) this block's q rows

  const int ib = blockIdx.x;
  const int ih = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int key = lane % BS;   // the key this lane scores
  const int part = lane / BS;  // which head-dim slice of it
  const int g = hq / hkv;
  const int rows_real = g * sq;
  const int off = kv_offset[ib];
  const int kv_end = kv_len[ib];
  const int q_len = q_lens[ib];

  // this warp's packed rows: row = head_in_group * sq + q_index
  float acc[kRowsPerWarp][kDimsPerLane];
  float m[kRowsPerWarp];
  float l[kRowsPerWarp];
  int qi[kRowsPerWarp];
  bool valid[kRowsPerWarp];
  size_t base[kRowsPerWarp];  // element offset of the row's q/out head
  float* qw = q_s + warp * kRowsPerWarp * hd;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = blockIdx.z * kRows + warp * kRowsPerWarp + r;
    valid[r] = row < rows_real;
    const int ig = valid[r] ? row / sq : 0;
    qi[r] = valid[r] ? row % sq : 0;
    base[r] = ((size_t)(ib * sq + qi[r]) * hq + (size_t)ih * g + ig) * hd;
    for (int d = lane; d < hd; d += 32)
      qw[r * hd + d] = valid[r] ? to_float(q[base[r] + d]) : 0.f;
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) acc[r][i] = 0.f;
    m[r] = kNegInf;
    l[r] = 0.f;
  }

  // live table entries only: from the first entry any query's window can
  // still see, to the last entry holding a position < kv_len
  int t_start = 0;
  if (window > 0) t_start = max(off - window + 1, 0) / BS;
  const int n_live = min((kv_end + BS - 1) / BS, n_tbl);
  const int chunks = hd / kVec;  // 16-byte loads per tile row

  for (int t = t_start; t < n_live; ++t) {
    const int phys = max(tables[(size_t)ib * n_tbl + t], 0);
    __syncthreads();  // every warp is done with the previous tile (and q_s)
    for (int c = threadIdx.x; c < BS * chunks; c += blockDim.x) {
      const int j = c / chunks;
      const int d0 = (c - j * chunks) * kVec;
      const size_t src = ((size_t)(phys * BS + j) * hkv + ih) * hd + d0;
      float kf[kVec], vf[kVec];
      unpack16(k_pool + src, kf);
      unpack16(v_pool + src, vf);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        k_s[j * k_stride + d0 + e] = kf[e];
        v_s[j * hd + d0 + e] = vf[e];
      }
    }
    __syncthreads();

    // scores of every row against this lane's key (partial over its dims)
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
#pragma unroll 8
    for (int d = part; d < hd; d += kParts) {
      const float kv = k_s[key * k_stride + d];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) s[r] += qw[r * hd + d] * kv;
    }
    float p[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
      for (int o = BS; o < 32; o <<= 1)
        s[r] += __shfl_xor_sync(kFull, s[r], o);  // join the dim slices
      const int kpos = t * BS + key;
      const int qpos = off + qi[r];
      bool ok = valid[r] && kpos < kv_end && qi[r] < q_len;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && kpos > qpos - window;
      const float sc = ok ? s[r] * scale : kNegInf;
      float mx = sc;
#pragma unroll
      for (int o = 1; o < BS; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float m_new = fmaxf(m[r], mx);
      const float m_safe = m_new <= kNegInf ? 0.f : m_new;
      p[r] = ok ? expf(sc - m_safe) : 0.f;
      const float alpha = m[r] <= kNegInf ? 0.f : expf(m[r] - m_safe);
      float ps = p[r];
#pragma unroll
      for (int o = 1; o < BS; o <<= 1) ps += __shfl_xor_sync(kFull, ps, o);
      l[r] = l[r] * alpha + ps;
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) acc[r][i] *= alpha;
    }
    // acc += p · V: lane j (< BS) holds key j's probability for every row
#pragma unroll
    for (int j = 0; j < BS; ++j) {
      float pj[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        pj[r] = __shfl_sync(kFull, p[r], j);
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < hd) {
          const float vv = v_s[j * hd + d];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) acc[r][i] += pj[r] * vv;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    if (!valid[r]) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < hd) out[base[r] + d] = from_float<T>(acc[r][i] * inv);
    }
  }
}

template <typename T, int BS>
void launch_bs(const void* q, const void* k_pool, const void* v_pool,
               const void* tables, const void* kv_offset, const void* kv_len,
               const void* q_lens, void* out, int b, int sq, int hq, int hkv,
               int hd, int n_tbl, int causal, int window, float scale,
               cudaStream_t stream) {
  const int rows = (hq / hkv) * sq;
  const dim3 grid(b, hkv, (rows + kRows - 1) / kRows);
  const int k_stride = hd + ((32 / BS - hd) % 32 + 32) % 32;
  const size_t smem =
      ((size_t)BS * k_stride + (size_t)BS * hd + (size_t)kRows * hd) *
      sizeof(float);
  paged_attention_kernel<T, BS><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(kv_offset), static_cast<const int*>(kv_len),
      static_cast<const int*>(q_lens), static_cast<T*>(out), sq, hq, hkv, hd,
      n_tbl, causal, window, scale);
}

// block sizes the kernel is compiled for (one key per lane: they divide 32)
template <typename T>
void launch(const void* q, const void* k_pool, const void* v_pool,
            const void* tables, const void* kv_offset, const void* kv_len,
            const void* q_lens, void* out, int b, int sq, int hq, int hkv,
            int hd, int bs, int n_tbl, int causal, int window, float scale,
            cudaStream_t stream) {
#define PAGED_ATTENTION_LAUNCH(BS_)                                          \
  launch_bs<T, BS_>(q, k_pool, v_pool, tables, kv_offset, kv_len, q_lens,    \
                    out, b, sq, hq, hkv, hd, n_tbl, causal, window, scale,   \
                    stream)
  switch (bs) {
    case 4: PAGED_ATTENTION_LAUNCH(4); break;
    case 8: PAGED_ATTENTION_LAUNCH(8); break;
    case 16: PAGED_ATTENTION_LAUNCH(16); break;
    case 32: PAGED_ATTENTION_LAUNCH(32); break;
  }
#undef PAGED_ATTENTION_LAUNCH
}

}  // namespace

// Plain C entry for ctypes. The caller (kernels/paged_attention.py) checks
// shapes, dtypes, devices and contiguity, allocates ``out`` and passes
// PyTorch's current stream. Returns cudaGetLastError() after the launch.
extern "C" int paged_attention_fwd(const void* q, const void* k_pool,
                                   const void* v_pool, const void* tables,
                                   const void* kv_offset, const void* kv_len,
                                   const void* q_lens, void* out, int b,
                                   int sq, int hq, int hkv, int hd, int bs,
                                   int n_tbl, int causal, int window,
                                   int is_bf16, float scale, void* stream) {
  if (bs != 4 && bs != 8 && bs != 16 && bs != 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    launch<__nv_bfloat16>(q, k_pool, v_pool, tables, kv_offset, kv_len,
                          q_lens, out, b, sq, hq, hkv, hd, bs, n_tbl, causal,
                          window, scale, st);
  } else {
    launch<float>(q, k_pool, v_pool, tables, kv_offset, kv_len, q_lens, out,
                  b, sq, hq, hkv, hd, bs, n_tbl, causal, window, scale, st);
  }
  return static_cast<int>(cudaGetLastError());
}
