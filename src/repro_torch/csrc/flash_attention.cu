// Flash-attention forward for Hopper (sm_90a): causal / sliding-window GQA
// over a full sequence, the training path's attention.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_bhsd (Pallas; body _attn_kernel). Same contract, in the
// model's own layout (the reference transposes to (B*H, S, hd) first; this
// kernel indexes the strides instead): q (b, sq, hq, hd), k / v
// (b, sk, hkv, hd), all contiguous, fp32 or bf16; out (b, sq, hq, hd) in q's
// dtype. GQA: query head h reads K/V head h / (hq / hkv), with no repeat_kv.
// Masks: kpos < sk, q_index < sq, causal kpos <= q_index + kv_offset,
// window kpos > q_index + kv_offset - window. Fully masked rows give 0.
// Online softmax in fp32 with the reference's guards: NEG_INF = -1e30,
// m_safe = 0 while the running max is still NEG_INF, alpha = 0 then, and
// out = acc / max(l, 1e-30).
//
// What bounds it on this card: operations. Each K/V element a block loads
// serves 64 query rows (4 * hd * 64 FLOPs per key and row tile), far above
// the H100's ridge, so the floor is 4 * hd * hq * (attended pairs) over
// the peak rate of the arithmetic. This first version does all arithmetic
// in fp32 on the CUDA cores (67 TFLOP/s), which the reference's 2e-5 fp32
// tolerance needs anyway (TF32 would not meet it). The design keeps the
// CUDA cores fed:
//   * one block per (64-row query tile, query head, batch row); the kv
//     loop lives inside the block with (m, l, acc) in registers, since
//     Hopper's blocks run in no order (the Pallas grid's sequential kv axis
//     becomes this loop);
//   * tiles wholly above the causal diagonal or outside the window are
//     skipped (they change no value), and the longest causal tiles are
//     launched first;
//   * 256 threads as 16 x 16: each thread scores 4 rows x 4 keys (keys
//     tx + 16 j) with 16-byte shared-memory reads, 8 loads per 64 FMAs,
//     and accumulates 4 rows x hd / 16 output columns;
//   * Q and K tiles sit in shared memory in fp32 with rows padded to
//     hd + 4 floats so those 16-byte reads hit distinct banks; P is stored
//     transposed over the K tile once the scores are done.
// mma.sync / wgmma, cp.async or TMA double buffering and a backward kernel
// are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kBQ = 64;        // query rows per block: 4 per thread row
constexpr int kBK = 64;        // keys per tile: 4 per thread column
constexpr int kPStride = kBQ + 4;  // P^T rows (conflict-free float4 stores)
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
__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

template <int HD>
struct Layout {
  static constexpr int kStride = HD + 4;  // Q / K tile rows, in floats
  static constexpr int kKRegion =
      kBK * kStride > kBK * kPStride ? kBK * kStride : kBK * kPStride;
  static constexpr size_t kSmemBytes =
      ((size_t)kBQ * kStride + kKRegion + (size_t)kBK * HD) * sizeof(float);
};

// rows [r0, r0 + rows) of a (.., seq, heads, HD) tensor's head `head` ->
// fp32 shared rows of `stride` floats; rows past `seq_len` are zero
template <typename T, int HD>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src,
                                           float* dst, int stride, int r0,
                                           int rows, int seq_len, int heads,
                                           int head, size_t batch_row) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = HD / kVec;
  for (int c = threadIdx.x; c < rows * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int d0 = (c - r * kChunks) * kVec;
    float f[kVec];
    if (r0 + r < seq_len) {
      load16(src + ((batch_row * seq_len + r0 + r) * heads + head) * HD + d0,
             f);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kVec; e += 4)
      *reinterpret_cast<float4*>(dst + r * stride + d0 + e) =
          make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int sq,
                       int sk, int hq, int hkv, int causal, int window,
                       int kv_offset, float scale) {
  using Lay = Layout<HD>;
  constexpr int kStride = Lay::kStride;
  // output columns per thread: 16-byte groups (tx * 4 + 64 * c) when
  // hd >= 64, else single columns (tx + 16 * c); both conflict-free
  constexpr bool kVecCols = HD >= 64;
  constexpr int kCols = HD / 16;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // (kBQ, kStride)
  float* k_s = q_s + kBQ * kStride;              // (kBK, kStride)
  float* p_s = k_s;                              // (kBK, kPStride): P^T
  float* v_s = k_s + Lay::kKRegion;              // (kBK, HD)

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // longest tiles first
  const int h = blockIdx.y;
  const size_t ib = blockIdx.z;
  const int hk = h / (hq / hkv);

  stage_rows<T, HD>(q, q_s, kStride, q0, kBQ, sq, hq, h, ib);

  // the kv range any row of this tile can attend
  const int q_last = min(q0 + kBQ, sq) - 1 + kv_offset;
  const int kv_end = causal ? min(sk, q_last + 1) : sk;
  const int kv_begin = window > 0 ? max(0, q0 + kv_offset - window + 1) : 0;

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = (kv_begin / kBK) * kBK; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous tile's P and V are consumed
    stage_rows<T, HD>(k, k_s, kStride, k0, kBK, sk, hkv, hk, ib);
    stage_rows<T, HD>(v, v_s, HD, k0, kBK, sk, hkv, hk, ib);
    __syncthreads();

    // scores: rows ty * 4 + i, keys tx + 16 * j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(
            q_s + (ty * 4 + i) * kStride + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const float4*>(
            k_s + (tx + 16 * j) * kStride + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
        }
    }

    // masks and the online-softmax step (the reference's, row by row);
    // a row's 64 keys sit on the 16 lanes sharing its ty
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      const int qpos = row + kv_offset;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = row < sq && kpos < sk;
        if (causal) ok[j] = ok[j] && kpos <= qpos;
        if (window > 0) ok[j] = ok[j] && kpos > qpos - window;
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float m_safe = m_new <= kNegInf ? 0.f : m_new;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = ok[j] ? expf(s[i][j] - m_safe) : 0.f;
        ps += p[i][j];
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) ps += __shfl_xor_sync(kFull, ps, o);
      const float alpha = m[i] <= kNegInf ? 0.f : expf(m[i] - m_safe);
      l[i] = l[i] * alpha + ps;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // every warp is done reading K: P^T overwrites it
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(p_s + (tx + 16 * j) * kPStride + ty * 4) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    __syncthreads();

    // acc += P · V (masked keys carry p = 0)
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float4 pj =
          *reinterpret_cast<const float4*>(p_s + j * kPStride + ty * 4);
      const float pr[4] = {pj.x, pj.y, pj.z, pj.w};
      const float* vrow = v_s + j * HD;
      if constexpr (kVecCols) {
#pragma unroll
        for (int c = 0; c < kCols; c += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(
              vrow + tx * 4 + 16 * c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][c] = fmaf(pr[i], vv.x, acc[i][c]);
            acc[i][c + 1] = fmaf(pr[i], vv.y, acc[i][c + 1]);
            acc[i][c + 2] = fmaf(pr[i], vv.z, acc[i][c + 2]);
            acc[i][c + 3] = fmaf(pr[i], vv.w, acc[i][c + 3]);
          }
        }
      } else {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float vv = vrow[tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pr[i], vv, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = out + ((ib * sq + row) * hq + h) * HD;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = kVecCols ? tx * 4 + 16 * (c & ~3) + (c & 3)
                               : tx + 16 * c;
      orow[col] = from_float<T>(acc[i][c] * inv);
    }
  }
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* out, int b,
              int sq, int sk, int hq, int hkv, int causal, int window,
              int kv_offset, float scale, cudaStream_t stream) {
  const size_t smem = Layout<HD>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  flash_attention_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, sk, hq, hkv,
      causal, window, kv_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int sq, int sk, int hq, int hkv, int hd, int causal, int window,
           int kv_offset, float scale, cudaStream_t stream) {
#define FLASH_ATTENTION_LAUNCH(HD_)                                          \
  return launch_hd<T, HD_>(q, k, v, out, b, sq, sk, hq, hkv, causal, window, \
                           kv_offset, scale, stream)
  switch (hd) {
    case 16: FLASH_ATTENTION_LAUNCH(16);
    case 32: FLASH_ATTENTION_LAUNCH(32);
    case 64: FLASH_ATTENTION_LAUNCH(64);
    case 128: FLASH_ATTENTION_LAUNCH(128);
  }
#undef FLASH_ATTENTION_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry for ctypes. The caller (kernels/flash_attention.py) checks
// shapes, dtypes, devices and contiguity, allocates ``out`` and passes
// PyTorch's current stream. Returns the first CUDA error of the launch
// (cudaGetLastError() after it), 0 on success.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int b, int sq,
                                   int sk, int hq, int hkv, int hd,
                                   int causal, int window, int kv_offset,
                                   int is_bf16, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, out, b, sq, sk, hq, hkv, hd,
                                 causal, window, kv_offset, scale, st);
  return launch<float>(q, k, v, out, b, sq, sk, hq, hkv, hd, causal, window,
                       kv_offset, scale, st);
}
