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
// serves 64 query rows (4 * hd FLOPs per key and row), far above the
// H100's ridge, so the floor is 4 * hd * hq * (attended pairs) over the
// peak rate of the arithmetic. Both variants keep one block per query tile
// of one head with the kv loop inside it and (m, l, acc) in registers
// (Hopper's blocks run in no order: the Pallas grid's sequential kv axis
// becomes this loop), skip tiles wholly above the causal diagonal or
// outside the window (they change no value), launch the longest causal
// tiles first, and stage every tile with cp.async.
//
// bf16: an FA2-style forward on the tensor cores (989 TFLOP/s). 4 warps
// own 16 query rows each; Q is loaded once into shared memory (the ring's
// second stage, so a block takes 70 KB and three share an SM) and then into
// A fragments; 64-key K / V tiles come through a 2-stage cp.async ring
// with one barrier per tile (a warp skips the tiles its own rows cannot
// see). 8-warp blocks and 128-key tiles measured within 4 % of this, either
// side (scripts/attention_variants.py). S = Q K^T and O += P V run through
// mma.sync m16n8k16 with fp32 accumulators, P rounded to bf16 in registers
// (hi + lo) as the A fragments of P V and V read with ldmatrix.trans
// (attention_tile.cuh).
//
// fp32: CUDA cores (67 TFLOP/s), because the reference's 2e-5 tolerance
// rules out TF32. 256 threads as 16 x 16 own 64 query rows: each thread
// scores 4 rows x 4 keys (keys tx + 16 j) with 16-byte shared-memory reads
// and accumulates 4 rows x hd / 16 output columns: 16-byte groups when hd
// is a multiple of 64, else single columns tx + 16 c (zamba2-7b's head
// dim 112: 7 columns a thread). Q, K tiles have rows
// padded to hd + 4 floats so those reads hit distinct banks; P is stored
// transposed over the consumed K tile. About 100 KB of shared memory, so
// two blocks share an SM and one's barriers hide behind the other's FMAs;
// that leaves no room for a second K / V stage, so cp.async lets each
// tile's V load under its scores instead. (A 128-row block of 512 threads
// with a double-buffered ring, one block an SM, measured slower: 1.47 ms
// against 1.37 at the training shape.) wgmma with TMA, and a backward
// kernel, are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "attention_tile.cuh"

namespace {

using attn::kNegInf;
using bf16 = __nv_bfloat16;
constexpr unsigned kFull = 0xffffffffu;


// the kv tiles any row of a query tile [q0, q0 + rows) can attend
template <int BK>
struct KvRange {
  int t_begin, t_end;
  __device__ KvRange(int q0, int rows, int sq, int sk, int causal,
                     int window, int kv_offset) {
    const int q_last = min(q0 + rows, sq) - 1 + kv_offset;
    const int kv_end = causal ? min(sk, q_last + 1) : sk;
    const int kv_begin = window > 0 ? max(0, q0 + kv_offset - window + 1) : 0;
    t_begin = kv_begin / BK;
    t_end = kv_end > 0 ? (kv_end + BK - 1) / BK : 0;
  }
};

// rows [r0, r0 + rows) of a (.., seq, heads, HD) tensor's head `head` ->
// shared rows of `stride` elements by cp.async; rows past `seq_len` are
// zero-filled
template <typename T, int HD>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src, T* dst,
                                           int stride, int r0, int rows,
                                           int seq_len, int heads, int head,
                                           size_t batch_row) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = HD / kVec;
  for (int c = threadIdx.x; c < rows * kChunks; c += blockDim.x) {
    const int r = c / kChunks;
    const int d0 = (c - r * kChunks) * kVec;
    const bool ok = r0 + r < seq_len;
    const T* s = ok ? src + ((batch_row * seq_len + r0 + r) * heads + head) *
                                HD + d0
                    : src;
    attn::cp_async16(dst + r * stride + d0, s, ok);
  }
}

// ------------------------------------------------------- bf16: tensor cores

constexpr int kMmaWarps = 4;
constexpr int kMmaMinBlocks = 3;  // resident blocks per SM (register cap)
constexpr int kMmaRows = 16 * kMmaWarps;  // query rows per block
constexpr int kMmaKeys = 64;              // keys per K / V tile

template <int HD>
constexpr size_t mma_smem_bytes() {  // 2 x (K, V); Q lives in stage 1
  static_assert(kMmaRows <= 2 * kMmaKeys, "Q fits stage 1");
  return (size_t)4 * kMmaKeys * (HD + 8) * sizeof(bf16);
}

template <int HD>
__global__ void __launch_bounds__(kMmaWarps * 32, kMmaMinBlocks)
flash_attention_mma_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ out,
                           int sq, int sk, int hq, int hkv, int causal,
                           int window, int kv_offset, float scale_log2) {
  constexpr int kStride = HD + 8;
  constexpr int kTile = kMmaKeys * kStride;  // one K or V tile
  extern __shared__ uint4 smem_u4[];
  // stage s: K at 2 s kTile, V next. Q is staged in stage 1 and moves to
  // registers before the ring first refills it.
  bf16* kv_s = reinterpret_cast<bf16*>(smem_u4);
  bf16* q_s = kv_s + 2 * kTile;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kMmaRows;  // longest first
  const int h = blockIdx.y;
  const size_t ib = blockIdx.z;
  const int hk = h / (hq / hkv);
  const KvRange<kMmaKeys> range(q0, kMmaRows, sq, sk, causal, window,
                                kv_offset);

  // this lane's rows g and g + 8 of its warp: keys lo .. hi (inclusive)
  int lo[2], hi[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = q0 + warp * 16 + (lane >> 2) + 8 * rr;
    const int qpos = row + kv_offset;
    hi[rr] = row < sq ? (causal ? min(qpos, sk - 1) : sk - 1) : -1;
    lo[rr] = window > 0 ? max(qpos - window + 1, 0) : 0;
  }
  // the keys this warp's rows can attend (a warp skips the tiles outside)
  const bool live0 = hi[0] >= lo[0], live1 = hi[1] >= lo[1];
  const int warp_lo = __reduce_min_sync(
      kFull, min(live0 ? lo[0] : INT_MAX, live1 ? lo[1] : INT_MAX));
  const int warp_hi = __reduce_max_sync(
      kFull, max(live0 ? hi[0] : -1, live1 ? hi[1] : -1));

  auto load_tile = [&](int t) {
    bf16* k_dst = kv_s + ((t - range.t_begin) & 1) * 2 * kTile;
    stage_rows<bf16, HD>(k, k_dst, kStride, t * kMmaKeys, kMmaKeys, sk, hkv,
                         hk, ib);
    stage_rows<bf16, HD>(v, k_dst + kTile, kStride, t * kMmaKeys, kMmaKeys,
                         sk, hkv, hk, ib);
  };

  stage_rows<bf16, HD>(q, q_s, kStride, q0, kMmaRows, sq, hq, h, ib);
  if (range.t_begin < range.t_end) load_tile(range.t_begin);
  attn::cp_async_commit();

  attn::RowState<HD> st;
  st.init();
  uint32_t qf[HD / 16][4];
  for (int t = range.t_begin; t < range.t_end; ++t) {
    attn::cp_async_wait<0>();  // tile t (and, first, Q) has landed
    __syncthreads();           // ... for every thread; tile t - 1 is done
    if (t == range.t_begin) {
      attn::load_q_fragments<HD>(qf, q_s, kStride, warp * 16);
      __syncthreads();  // Q is in registers: stage 1 may refill
    }
    if (t + 1 < range.t_end) load_tile(t + 1);
    attn::cp_async_commit();
    if (warp_hi < t * kMmaKeys || warp_lo >= (t + 1) * kMmaKeys) continue;
    const bf16* k_s = kv_s + ((t - range.t_begin) & 1) * 2 * kTile;
    attn::attend_tile<HD, kMmaKeys>(qf, k_s, k_s + kTile, kStride,
                                    t * kMmaKeys, lo, hi, scale_log2, st);
  }
  attn::cp_async_wait<0>();

  const int tq = lane & 3;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = q0 + warp * 16 + (lane >> 2) + 8 * rr;
    if (row >= sq) continue;
    const float inv = st.inv_l(rr);
    bf16* o = out + ((ib * sq + row) * hq + h) * HD;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i)
      *reinterpret_cast<uint32_t*>(o + i * 8 + 2 * tq) = attn::pack_bf16(
          st.acc[i][2 * rr] * inv, st.acc[i][2 * rr + 1] * inv);
  }
}

// ---------------------------------------------------------- fp32: CUDA cores

constexpr int kThreads = 256;  // 16 x 16
constexpr int kBQ = 64;        // query rows per block: 4 per thread row
constexpr int kBK = 64;        // keys per tile: 4 per thread column
constexpr int kPStride = kBQ + 4;  // P^T rows (conflict-free float4 stores)

template <int HD>
struct Layout {
  static constexpr int kStride = HD + 4;  // Q / K tile rows, in floats
  static constexpr int kKRegion =
      kBK * kStride > kBK * kPStride ? kBK * kStride : kBK * kPStride;
  static constexpr size_t kSmemBytes =
      ((size_t)kBQ * kStride + kKRegion + (size_t)kBK * HD) * sizeof(float);
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_fp32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            float* __restrict__ out, int sq, int sk, int hq,
                            int hkv, int causal, int window, int kv_offset,
                            float scale) {
  using Lay = Layout<HD>;
  constexpr int kStride = Lay::kStride;
  // output columns per thread: 16-byte groups (tx * 4 + 64 * (c / 4))
  // when hd is a multiple of 64, else single columns (tx + 16 * c); both
  // conflict-free
  static_assert(HD % 16 == 0, "16 column lanes");
  constexpr bool kVecCols = HD % 64 == 0;
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
  const KvRange<kBK> range(q0, kBQ, sq, sk, causal, window, kv_offset);

  stage_rows<float, HD>(q, q_s, kStride, q0, kBQ, sq, hq, h, ib);
  attn::cp_async_commit();

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int t = range.t_begin; t < range.t_end; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's P^T and V are consumed
    stage_rows<float, HD>(k, k_s, kStride, k0, kBK, sk, hkv, hk, ib);
    attn::cp_async_commit();
    stage_rows<float, HD>(v, v_s, HD, k0, kBK, sk, hkv, hk, ib);
    attn::cp_async_commit();
    attn::cp_async_wait<1>();  // Q and K have landed; V loads under S
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
    attn::cp_async_wait<0>();  // V has landed
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
  attn::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    float* orow = out + ((ib * sq + row) * hq + h) * HD;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = kVecCols ? tx * 4 + 16 * (c & ~3) + (c & 3)
                               : tx + 16 * c;
      orow[col] = acc[i][c] * inv;
    }
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, void* out, int b,
              int sq, int sk, int hq, int hkv, int causal, int window,
              int kv_offset, int is_bf16, float scale, cudaStream_t stream) {
  if (is_bf16) {
    const size_t smem = mma_smem_bytes<HD>();
    const int err = set_smem(flash_attention_mma_kernel<HD>, smem);
    if (err) return err;
    const dim3 grid((sq + kMmaRows - 1) / kMmaRows, hq, b);
    flash_attention_mma_kernel<HD><<<grid, kMmaWarps * 32, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(out), sq, sk, hq,
        hkv, causal, window, kv_offset, scale * attn::kLog2e);
  } else {
    const size_t smem = Layout<HD>::kSmemBytes;
    const int err = set_smem(flash_attention_fp32_kernel<HD>, smem);
    if (err) return err;
    const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
    flash_attention_fp32_kernel<HD><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), sq, sk, hq,
        hkv, causal, window, kv_offset, scale);
  }
  return static_cast<int>(cudaGetLastError());
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
#define FLASH_ATTENTION_LAUNCH(HD_)                                          \
  return launch_hd<HD_>(q, k, v, out, b, sq, sk, hq, hkv, causal, window,    \
                        kv_offset, is_bf16, scale, st)
  switch (hd) {
    case 16: FLASH_ATTENTION_LAUNCH(16);
    case 32: FLASH_ATTENTION_LAUNCH(32);
    case 64: FLASH_ATTENTION_LAUNCH(64);
    case 112: FLASH_ATTENTION_LAUNCH(112);
    case 128: FLASH_ATTENTION_LAUNCH(128);
  }
#undef FLASH_ATTENTION_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
