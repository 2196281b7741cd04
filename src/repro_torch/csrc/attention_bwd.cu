// Attention backward for Hopper (sm_90a): the gradients of K1's attention
// (causal / sliding-window GQA over a full sequence, the training path).
//
// Replaces no TPU kernel. The JAX package's K1 backward (``_flash_bwd`` in
// src/repro/kernels/ops.py) is jax.vjp through the chunked jnp attention
// only because pallas_call has no AD rule; the port ran the same thing as
// autograd through ``layers.chunked_attention``, which on the card is
// thousands of small ops a call, every causal block computed, and the
// chunked forward run twice. This file is new work for the card, after
// FlashAttention-2's backward (Dao, 2023), deterministic.
//
// Contract: K1's forward's (kernels/flash_attention.py), plus the forward's
// output ``out`` and its cotangent ``dout``. q, out, dout (b, sq, hq, hd);
// k, v (b, sk, hkv, hd); all contiguous, one dtype, fp32 or bf16; the
// gradients dq, dk, dv in that dtype. GQA: query head h reads K/V head
// h / (hq / hkv). Masks as the forward's: kpos < sk, q_index < sq, causal
// kpos <= q_index + kv_offset, window kpos > q_index + kv_offset - window;
// a fully masked row has P = 0, so a zero gradient and never NaN. All
// arithmetic is fp32 on the CUDA cores (bf16 inputs are widened as they are
// staged into shared memory): the reference's 2e-5 tolerance rules out TF32.
//
// Three passes, as FlashAttention-2:
//   (a) attn_bwd_rowstats: a block owns 64 query rows of one head; by its
//       own pass over the K tiles the rows can attend it computes the
//       log-sum-exp lse = m + log(l) of the scaled scores (the forward's
//       online max and sum, without P V), and D = rowsum(dout * out).
//   (b) attn_bwd_dkdv: a block owns 64 keys of one KV head, K and V in
//       shared memory, and loops over the query heads of its GQA group
//       (or a share of them) and the 64-row query tiles that can see its
//       keys (tiles outside the causal diagonal or the window are
//       skipped, as the forward's KvRange skips K tiles). For each it
//       recomputes S^T = K Q^T, P^T = exp(S^T scale - lse) and
//       dP^T = V dout^T, dS^T = P^T * (dP^T - D), and accumulates
//       dV += P^T dout and dK += dS^T Q * scale in registers; each is
//       written once.
//   (c) attn_bwd_dq: a block owns 64 query rows of one head and loops over
//       their K / V tiles: S, P, dP and dS again, dQ += dS K * scale.
// No atomics: every gradient element is summed by one thread in a fixed
// order, so a gradient is the same from run to run. Where the grid of (b)
// would leave SMs idle (chatglm3-6b: 32 query heads on 2 KV heads, b 1, 32
// key tiles = 64 blocks on 132 SMs), the wrapper splits each group's query
// heads over ``n_split`` blocks; each writes a partial dK / dV to fp32
// scratch and attn_bwd_dkdv_reduce sums the partials in split order.
//
// What bounds it on this card: operations. Each Q, dout, K or V element a
// block stages serves 64 rows or keys of 4 * hd FLOPs, far above the
// ridge. The algorithm needs five products a (query, key) pair (S, dP, dV,
// dK, dQ); this design does eight (the row pass's S, and the dQ pass's S
// and dP, again) to keep every sum in one block. The tiles follow K1's
// fp32 forward: 256 threads as 16 x 16, each thread 4 x 4 scores with
// 16-byte shared-memory reads, shared rows padded to hd + 4 floats so
// those reads hit distinct banks, and accumulators of 4 rows x hd / 16
// columns (16-byte groups when hd is a multiple of 64, else single
// columns).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_tile.cuh"

namespace {

using attn::kNegInf;
using bf16 = __nv_bfloat16;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kThreads = 256;  // 16 x 16
constexpr int kRows = 64;      // query rows a tile: 4 per thread row
constexpr int kKeys = 64;      // keys a tile: 4 per thread column
constexpr int kPStride = 68;   // rows of a staged 64-wide P / dS tile

template <int HD>
struct Tiles {
  static_assert(HD % 16 == 0, "16 column lanes");
  static constexpr int kStride = HD + 4;       // staged Q / K / V / dO rows
  static constexpr int kTile = 64 * kStride;   // one staged tile, in floats
  static constexpr bool kVecCols = HD % 64 == 0;
  static constexpr int kCols = HD / 16;        // accumulator columns a thread
  // a thread's accumulator column c: 16-byte groups or single columns
  __device__ static int col(int tx, int c) {
    return kVecCols ? tx * 4 + 16 * (c & ~3) + (c & 3) : tx + 16 * c;
  }
};

// the 64-key tiles any row of a query tile [q0, q0 + 64) can attend (K1's
// forward's KvRange)
struct KeyTiles {
  int t_begin, t_end;
  __device__ KeyTiles(int q0, int sq, int sk, int causal, int window,
                      int kv_offset) {
    const int q_last = min(q0 + kRows, sq) - 1 + kv_offset;
    const int kv_end = causal ? min(sk, q_last + 1) : sk;
    const int kv_begin = window > 0 ? max(0, q0 + kv_offset - window + 1) : 0;
    t_begin = kv_begin / kKeys;
    t_end = kv_end > 0 ? (kv_end + kKeys - 1) / kKeys : 0;
  }
};

// the 64-row query tiles that can see any key of the key tile [k0, k0 + 64)
struct RowTiles {
  int t_begin, t_end;
  __device__ RowTiles(int k0, int sq, int sk, int causal, int window,
                      int kv_offset) {
    const int k_last = min(k0 + kKeys, sk) - 1;
    const int lo = causal ? max(0, k0 - kv_offset) : 0;
    const int hi = window > 0 ? min(sq, k_last - kv_offset + window) : sq;
    t_begin = lo / kRows;
    t_end = hi > lo ? (hi + kRows - 1) / kRows : t_begin;
  }
};

__device__ __forceinline__ bool visible(int row, int kpos, int sq, int sk,
                                        int causal, int window,
                                        int kv_offset) {
  const int qpos = row + kv_offset;
  return row < sq && kpos < sk && (!causal || kpos <= qpos) &&
         (window <= 0 || kpos > qpos - window);
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 narrow<bf16>(float x) {
  return __float2bfloat16(x);
}

// rows [r0, r0 + 64) of a (.., seq, heads, HD) tensor's head `head` ->
// fp32 shared rows of `stride` floats; rows past `seq_len` are zeros. fp32
// by cp.async (wait with cp_async_wait); bf16 widened through registers.
template <typename T, int HD>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src,
                                           float* dst, int stride, int r0,
                                           int seq_len, int heads, int head,
                                           size_t batch) {
  if constexpr (std::is_same<T, float>::value) {
    constexpr int kChunks = HD / 4;
    for (int c = threadIdx.x; c < 64 * kChunks; c += kThreads) {
      const int r = c / kChunks;
      const int d0 = (c - r * kChunks) * 4;
      const bool ok = r0 + r < seq_len;
      const float* s =
          ok ? src + ((batch * seq_len + r0 + r) * heads + head) * HD + d0
             : src;
      attn::cp_async16(dst + r * stride + d0, s, ok);
    }
  } else {
    constexpr int kChunks = HD / 8;
    for (int c = threadIdx.x; c < 64 * kChunks; c += kThreads) {
      const int r = c / kChunks;
      const int d0 = (c - r * kChunks) * 8;
      float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (r0 + r < seq_len) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            src + ((batch * seq_len + r0 + r) * heads + head) * HD + d0);
        const __nv_bfloat162* p =
            reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(p[i]);
          x[2 * i] = f.x;
          x[2 * i + 1] = f.y;
        }
      }
      float4* d = reinterpret_cast<float4*>(dst + r * stride + d0);
      d[0] = make_float4(x[0], x[1], x[2], x[3]);
      d[1] = make_float4(x[4], x[5], x[6], x[7]);
    }
  }
}

// acc[i][j] = a row (a0 + 4 i) . b row (b0 + 16 j), over HD: the 4 x 4
// block of a 64 x 64 product of two staged tiles that a thread owns
template <int HD>
__device__ __forceinline__ void tile_dots(const float* a, const float* b,
                                          int a0, int b0, float (&acc)[4][4]) {
  constexpr int kStride = Tiles<HD>::kStride;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = *reinterpret_cast<const float4*>(a + (a0 + i) * kStride + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      y[j] = *reinterpret_cast<const float4*>(b + (b0 + 16 * j) * kStride + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(x[i].x, y[j].x, acc[i][j]);
        acc[i][j] = fmaf(x[i].y, y[j].y, acc[i][j]);
        acc[i][j] = fmaf(x[i].z, y[j].z, acc[i][j]);
        acc[i][j] = fmaf(x[i].w, y[j].w, acc[i][j]);
      }
  }
}

// acc[i][c] += w[i] * row[col(tx, c)]: one step of a thread's (4 x HD / 16)
// share of a P^T X style product, for one staged row of X
template <int HD>
__device__ __forceinline__ void axpy_row(const float (&w)[4],
                                         const float* row, int tx,
                                         float (&acc)[4][Tiles<HD>::kCols]) {
  constexpr int kCols = Tiles<HD>::kCols;
  if constexpr (Tiles<HD>::kVecCols) {
#pragma unroll
    for (int c = 0; c < kCols; c += 4) {
      const float4 x =
          *reinterpret_cast<const float4*>(row + tx * 4 + 16 * c);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][c] = fmaf(w[i], x.x, acc[i][c]);
        acc[i][c + 1] = fmaf(w[i], x.y, acc[i][c + 1]);
        acc[i][c + 2] = fmaf(w[i], x.z, acc[i][c + 2]);
        acc[i][c + 3] = fmaf(w[i], x.w, acc[i][c + 3]);
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const float x = row[tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(w[i], x, acc[i][c]);
    }
  }
}

// ------------------------------------------------------- (a) the row pass

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
attn_bwd_rowstats_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ out,
                         const T* __restrict__ dout, float* __restrict__ lse,
                         float* __restrict__ dsum, int sq, int sk, int hq,
                         int hkv, int causal, int window, int kv_offset,
                         float scale) {
  using Tl = Tiles<HD>;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + Tl::kTile;

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int h = blockIdx.x % hq;
  const size_t ib = blockIdx.x / hq;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // longest first
  const int hk = h / (hq / hkv);
  const KeyTiles range(q0, sq, sk, causal, window, kv_offset);

  stage_rows<T, HD>(q, q_s, Tl::kStride, q0, sq, hq, h, ib);
  attn::cp_async_commit();

  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  for (int t = range.t_begin; t < range.t_end; ++t) {
    const int k0 = t * kKeys;
    __syncthreads();  // the previous K tile is consumed
    stage_rows<T, HD>(k, k_s, Tl::kStride, k0, sk, hkv, hk, ib);
    attn::cp_async_commit();
    attn::cp_async_wait<0>();
    __syncthreads();
    float s[4][4];
    tile_dots<HD>(q_s, k_s, ty * 4, tx, s);
    // the forward's online max and sum, row by row; a row's 64 keys sit on
    // the 16 lanes sharing its ty
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ok[j] = visible(row, k0 + tx + 16 * j, sq, sk, causal, window,
                        kv_offset);
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
      for (int j = 0; j < 4; ++j) ps += ok[j] ? expf(s[i][j] - m_safe) : 0.f;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) ps += __shfl_xor_sync(kFull, ps, o);
      const float alpha = m[i] <= kNegInf ? 0.f : expf(m[i] - m_safe);
      l[i] = l[i] * alpha + ps;
      m[i] = m_new;
    }
  }
  attn::cp_async_wait<0>();

  // lse (0 for a row with no visible key: its P is 0 wherever it is used)
  // and D = rowsum(dout * out), columns tx + 16 c of the row
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    float d = 0.f;
    if (row < sq) {
      const size_t base = ((ib * sq + row) * hq + h) * HD;
#pragma unroll
      for (int c = 0; c < HD / 16; ++c)
        d = fmaf(widen(dout[base + tx + 16 * c]),
                 widen(out[base + tx + 16 * c]), d);
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) d += __shfl_xor_sync(kFull, d, o);
    if (row < sq && tx == 0) {
      const size_t at = (ib * hq + h) * sq + row;
      lse[at] = l[i] > 0.f ? m[i] + logf(l[i]) : 0.f;
      dsum[at] = d;
    }
  }
}

// --------------------------------------------------------- (b) dK and dV

template <int HD>
struct DkdvLayout {  // K, V, Q, dO tiles; P and dS as [row][key]
  static constexpr size_t kFloats =
      4 * (size_t)Tiles<HD>::kTile + 2 * kRows * kPStride + 2 * kRows;
  static constexpr size_t kSmemBytes = kFloats * sizeof(float);
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, HD <= 64 ? 2 : 1)
attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dsum, T* __restrict__ dk,
                     T* __restrict__ dv, float* __restrict__ part, int b,
                     int sq, int sk, int hq, int hkv, int causal, int window,
                     int kv_offset, int n_split, float scale) {
  using Tl = Tiles<HD>;
  constexpr int kStride = Tl::kStride;
  constexpr int kCols = Tl::kCols;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  float* v_s = k_s + Tl::kTile;
  float* q_s = v_s + Tl::kTile;
  float* do_s = q_s + Tl::kTile;
  float* p_s = do_s + Tl::kTile;     // (kRows, kPStride): P
  float* ds_s = p_s + kRows * kPStride;  // dS
  float* lse_s = ds_s + kRows * kPStride;
  float* dsum_s = lse_s + kRows;

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int split = blockIdx.x % n_split;
  const int hk = (blockIdx.x / n_split) % hkv;
  const size_t ib = blockIdx.x / (n_split * hkv);
  const int k0 = blockIdx.y * kKeys;  // causal: the first tiles see most
  const int group = hq / hkv;
  const int per_split = group / n_split;
  const int h_begin = hk * group + split * per_split;
  const RowTiles range(k0, sq, sk, causal, window, kv_offset);

  stage_rows<T, HD>(k, k_s, kStride, k0, sk, hkv, hk, ib);
  stage_rows<T, HD>(v, v_s, kStride, k0, sk, hkv, hk, ib);
  attn::cp_async_commit();

  float dk_acc[4][kCols], dv_acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int h = h_begin; h < h_begin + per_split; ++h) {
    for (int t = range.t_begin; t < range.t_end; ++t) {
      const int q0 = t * kRows;
      __syncthreads();  // the previous tile's Q, dO, P and dS are consumed
      stage_rows<T, HD>(q, q_s, kStride, q0, sq, hq, h, ib);
      stage_rows<T, HD>(dout, do_s, kStride, q0, sq, hq, h, ib);
      attn::cp_async_commit();
      if (tid < kRows) {
        const int row = q0 + tid;
        const size_t at = (ib * hq + h) * sq + row;
        lse_s[tid] = row < sq ? lse[at] : 0.f;
        dsum_s[tid] = row < sq ? dsum[at] : 0.f;
      }
      attn::cp_async_wait<0>();
      __syncthreads();

      // S^T and dP^T: keys ty * 4 + i, rows tx + 16 j
      float s[4][4], dp[4][4];
      tile_dots<HD>(k_s, q_s, ty * 4, tx, s);
      tile_dots<HD>(v_s, do_s, ty * 4, tx, dp);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j;
        const float row_lse = lse_s[r], row_d = dsum_s[r];
        float p[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool ok = visible(q0 + r, k0 + ty * 4 + i, sq, sk, causal,
                                  window, kv_offset);
          p[i] = ok ? expf(s[i][j] * scale - row_lse) : 0.f;
          ds[i] = p[i] * (dp[i][j] - row_d);
        }
        *reinterpret_cast<float4*>(p_s + r * kPStride + ty * 4) =
            make_float4(p[0], p[1], p[2], p[3]);
        *reinterpret_cast<float4*>(ds_s + r * kPStride + ty * 4) =
            make_float4(ds[0], ds[1], ds[2], ds[3]);
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q over the tile's rows (masked rows and
      // keys carry P = dS = 0)
#pragma unroll 2
      for (int r = 0; r < kRows; ++r) {
        const float4 pr =
            *reinterpret_cast<const float4*>(p_s + r * kPStride + ty * 4);
        const float4 dr =
            *reinterpret_cast<const float4*>(ds_s + r * kPStride + ty * 4);
        const float pw[4] = {pr.x, pr.y, pr.z, pr.w};
        const float dw[4] = {dr.x, dr.y, dr.z, dr.w};
        axpy_row<HD>(pw, do_s + r * kStride, tx, dv_acc);
        axpy_row<HD>(dw, q_s + r * kStride, tx, dk_acc);
      }
    }
  }
  attn::cp_async_wait<0>();

  // each key row once: into dk / dv, or this split's fp32 partial
  const size_t n_kv = (size_t)b * sk * hkv * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key >= sk) continue;
    const size_t base = ((ib * sk + key) * hkv + hk) * HD;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const size_t at = base + Tl::col(tx, c);
      if (n_split == 1) {
        dk[at] = narrow<T>(dk_acc[i][c] * scale);
        dv[at] = narrow<T>(dv_acc[i][c]);
      } else {
        part[split * n_kv + at] = dk_acc[i][c] * scale;
        part[(n_split + split) * n_kv + at] = dv_acc[i][c];
      }
    }
  }
}

// dk / dv = the splits' partials summed in split order
template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_reduce_kernel(const float* __restrict__ part,
                            T* __restrict__ dk, T* __restrict__ dv,
                            size_t n_kv, int n_split) {
  const size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= 2 * n_kv) return;
  const size_t which = e / n_kv, at = e - which * n_kv;
  const float* p = part + which * n_split * n_kv + at;
  float acc = 0.f;
  for (int s = 0; s < n_split; ++s) acc += p[s * n_kv];
  (which ? dv : dk)[at] = narrow<T>(acc);
}

// --------------------------------------------------------------- (c) dQ

template <int HD>
struct DqLayout {  // Q, dO, K, V tiles; dS as [key][row]
  static constexpr size_t kSmemBytes =
      (4 * (size_t)Tiles<HD>::kTile + kKeys * kPStride) * sizeof(float);
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, HD <= 64 ? 2 : 1)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ dsum, T* __restrict__ dq,
                   int sq, int sk, int hq, int hkv, int causal, int window,
                   int kv_offset, float scale) {
  using Tl = Tiles<HD>;
  constexpr int kStride = Tl::kStride;
  constexpr int kCols = Tl::kCols;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* do_s = q_s + Tl::kTile;
  float* k_s = do_s + Tl::kTile;
  float* v_s = k_s + Tl::kTile;
  float* ds_s = v_s + Tl::kTile;  // (kKeys, kPStride): dS^T

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int h = blockIdx.x % hq;
  const size_t ib = blockIdx.x / hq;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // longest first
  const int hk = h / (hq / hkv);
  const KeyTiles range(q0, sq, sk, causal, window, kv_offset);

  stage_rows<T, HD>(q, q_s, kStride, q0, sq, hq, h, ib);
  stage_rows<T, HD>(dout, do_s, kStride, q0, sq, hq, h, ib);
  attn::cp_async_commit();
  float row_lse[4], row_d[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    const size_t at = (ib * hq + h) * sq + row;
    row_lse[i] = row < sq ? lse[at] : 0.f;
    row_d[i] = row < sq ? dsum[at] : 0.f;
  }

  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;

  for (int t = range.t_begin; t < range.t_end; ++t) {
    const int k0 = t * kKeys;
    __syncthreads();  // the previous tile's K and dS^T are consumed
    stage_rows<T, HD>(k, k_s, kStride, k0, sk, hkv, hk, ib);
    stage_rows<T, HD>(v, v_s, kStride, k0, sk, hkv, hk, ib);
    attn::cp_async_commit();
    attn::cp_async_wait<0>();
    __syncthreads();

    // S and dP: rows ty * 4 + i, keys tx + 16 j
    float s[4][4], dp[4][4];
    tile_dots<HD>(q_s, k_s, ty * 4, tx, s);
    tile_dots<HD>(do_s, v_s, ty * 4, tx, dp);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok = visible(q0 + ty * 4 + i, k0 + tx + 16 * j, sq, sk,
                                causal, window, kv_offset);
        const float p = ok ? expf(s[i][j] * scale - row_lse[i]) : 0.f;
        ds[i] = p * (dp[i][j] - row_d[i]);
      }
      *reinterpret_cast<float4*>(ds_s + (tx + 16 * j) * kPStride + ty * 4) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();

    // dQ += dS K over the tile's keys
#pragma unroll 4
    for (int j = 0; j < kKeys; ++j) {
      const float4 dj =
          *reinterpret_cast<const float4*>(ds_s + j * kPStride + ty * 4);
      const float w[4] = {dj.x, dj.y, dj.z, dj.w};
      axpy_row<HD>(w, k_s + j * kStride, tx, acc);
    }
  }
  attn::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= sq) continue;
    T* o = dq + ((ib * sq + row) * hq + h) * HD;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      o[Tl::col(tx, c)] = narrow<T>(acc[i][c] * scale);
  }
}

// ---------------------------------------------------------------- launch

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, void* dq, void* dk, void* dv, float* lse,
           float* dsum, float* part, int b, int sq, int sk, int hq, int hkv,
           int causal, int window, int kv_offset, int n_split, float scale,
           cudaStream_t stream) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* do_ = static_cast<const T*>(dout);
  const int q_tiles = (sq + kRows - 1) / kRows;
  const int k_tiles = (sk + kKeys - 1) / kKeys;

  const size_t row_smem = 2 * Tiles<HD>::kTile * sizeof(float);
  int err = set_smem(attn_bwd_rowstats_kernel<T, HD>, row_smem);
  if (err) return err;
  attn_bwd_rowstats_kernel<T, HD>
      <<<dim3(b * hq, q_tiles), kThreads, row_smem, stream>>>(
          q_, k_, static_cast<const T*>(out), do_, lse, dsum, sq, sk, hq,
          hkv, causal, window, kv_offset, scale);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;

  err = set_smem(attn_bwd_dkdv_kernel<T, HD>, DkdvLayout<HD>::kSmemBytes);
  if (err) return err;
  attn_bwd_dkdv_kernel<T, HD>
      <<<dim3(b * hkv * n_split, k_tiles), kThreads,
         DkdvLayout<HD>::kSmemBytes, stream>>>(
          q_, k_, v_, do_, lse, dsum, static_cast<T*>(dk),
          static_cast<T*>(dv), part, b, sq, sk, hq, hkv, causal, window,
          kv_offset, n_split, scale);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  if (n_split > 1) {
    const size_t n_kv = (size_t)b * sk * hkv * HD;
    attn_bwd_dkdv_reduce_kernel<T>
        <<<(unsigned)((2 * n_kv + kThreads - 1) / kThreads), kThreads, 0,
           stream>>>(part, static_cast<T*>(dk), static_cast<T*>(dv), n_kv,
                     n_split);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
  }

  err = set_smem(attn_bwd_dq_kernel<T, HD>, DqLayout<HD>::kSmemBytes);
  if (err) return err;
  attn_bwd_dq_kernel<T, HD>
      <<<dim3(b * hq, q_tiles), kThreads, DqLayout<HD>::kSmemBytes,
         stream>>>(q_, k_, v_, do_, lse, dsum, static_cast<T*>(dq), sq, sk,
                   hq, hkv, causal, window, kv_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry for ctypes. The caller (kernels/attention_bwd.py) checks
// shapes, dtypes, devices and contiguity, allocates the gradients and the
// fp32 scratch (lse and dsum (b, hq, sq); with n_split > 1, part
// (2, n_split, b, sk, hkv, hd)) and passes PyTorch's current stream.
// Returns the first CUDA error of the launches, 0 on success.
extern "C" int attention_bwd(const void* q, const void* k, const void* v,
                             const void* out, const void* dout, void* dq,
                             void* dk, void* dv, void* lse, void* dsum,
                             void* part, int b, int sq, int sk, int hq,
                             int hkv, int hd, int causal, int window,
                             int kv_offset, int n_split, int is_bf16,
                             float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse_ = static_cast<float*>(lse);
  float* dsum_ = static_cast<float*>(dsum);
  float* part_ = static_cast<float*>(part);
#define ATTN_BWD_LAUNCH(HD_)                                                 \
  return is_bf16                                                             \
             ? launch<bf16, HD_>(q, k, v, out, dout, dq, dk, dv, lse_,       \
                                 dsum_, part_, b, sq, sk, hq, hkv, causal,   \
                                 window, kv_offset, n_split, scale, st)      \
             : launch<float, HD_>(q, k, v, out, dout, dq, dk, dv, lse_,      \
                                  dsum_, part_, b, sq, sk, hq, hkv, causal,  \
                                  window, kv_offset, n_split, scale, st)
  switch (hd) {
    case 16: ATTN_BWD_LAUNCH(16);
    case 32: ATTN_BWD_LAUNCH(32);
    case 64: ATTN_BWD_LAUNCH(64);
    case 112: ATTN_BWD_LAUNCH(112);
    case 128: ATTN_BWD_LAUNCH(128);
  }
#undef ATTN_BWD_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
