// Device code shared by the attention kernels (flash_attention.cu, K1, and
// paged_attention.cu, K2), for Hopper (sm_90a):
//   * cp.async 16-byte global -> shared copies (zero-filled when the source
//     is out of range) with commit / wait groups;
//   * ldmatrix (and .trans) and mma.sync m16n8k16 bf16 -> fp32 fragments;
//   * the online-softmax step of one warp's 16 query rows against a tile of
//     keys in shared memory, on the accumulator fragments, with the
//     reference's guards (NEG_INF = -1e30, m_safe, alpha; out = acc /
//     max(l, 1e-30) in the epilogue).
// P enters P V as two bf16 terms, hi = bf16(p) and lo = bf16(p - hi), two
// mma per V fragment: P rounded once to bf16 (2^-9 relative) moves an
// output of magnitude 4 across a bf16 rounding boundary of the fp32
// reference, a 0.031 difference against the reference's 3e-2 (K2) and
// 2e-2 (K1) bf16 tolerances; with hi + lo, P V keeps fp32-level accuracy
// (measured: a 0.031 case falls to 0.002).
// Tiles in shared memory are bf16 rows of ``HD + 8`` elements: the 16-byte
// pad shifts each row by four banks, so the eight row addresses of an
// ldmatrix (and the 16-byte cp.async stores) hit distinct banks.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace attn {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------- cp.async

// 16 bytes global -> shared; ``valid`` false writes 16 zero bytes instead
// (``src`` must still be a mapped address: pass the tensor's base)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------ ldmatrix / mma.sync

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* src) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(src));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* src) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(src));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += a · b for one m16n8k16 tile: a (16 x 16, row) bf16, b (16 x 8, col)
// bf16, d (16 x 8) fp32. Lane (g = lane / 4, t = lane % 4) holds d rows g
// (d[0], d[1]) and g + 8 (d[2], d[3]), columns 2t and 2t + 1.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> bf16x2, ``lo`` in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) -> hi = bf16x2(x, y) and lo = bf16x2 of what hi leaves out
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

__device__ __forceinline__ float minus_inf() {
  return __int_as_float(0xff800000);
}

// 2^x on the special-function unit (relative error about 2^-22; -inf -> 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------------------- warp tiles

// One warp's A fragments of 16 query rows (row0 .. row0 + 15 of a bf16
// tile with ``stride`` elements per row), HD / 16 k-steps.
template <int HD>
__device__ __forceinline__ void load_q_fragments(
    uint32_t (&qf)[HD / 16][4], const __nv_bfloat16* tile, int stride,
    int row0) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* base =
      tile + (row0 + (lane & 15)) * stride + ((lane >> 4) << 3);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) ldmatrix_x4(qf[kk], base + kk * 16);
}

// The online-softmax state of one warp's 16 rows: each lane holds rows
// g and g + 8 (index 0 and 1), the output columns 8 i + 2 t, + 1.
template <int HD>
struct RowState {
  float acc[HD / 8][4];
  float m[2];  // running max, scaled by scale * log2(e); NEG_INF: none yet
  float l[2];  // running sum of exp2(score - m)

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < HD / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.f;
  }

  // 1 / max(l, 1e-30) of row r: a row that saw no key gives 0
  __device__ __forceinline__ float inv_l(int r) const {
    return 1.f / fmaxf(l[r], 1e-30f);
  }
};

// One warp's 16 rows (A fragments ``qf``) against BK keys of a K and a V
// tile in shared memory (bf16, ``stride`` elements per row, key k0 + j at
// row j). Row r of this lane may attend keys lo[r] <= key <= hi[r]
// (absolute positions; hi < lo masks the row). Scores are scaled by
// ``scale_log2`` = scale * log2(e), so exp2 of their differences is the
// reference's exp. S = Q K^T and O += P V run on the tensor cores; P is
// rounded to bf16 in registers, hi + lo, and reused as the A fragments of
// P V.
template <int HD, int BK>
__device__ __forceinline__ void attend_tile(const uint32_t (&qf)[HD / 16][4],
                                            const __nv_bfloat16* k_s,
                                            const __nv_bfloat16* v_s,
                                            int stride, int k0,
                                            const int (&lo)[2],
                                            const int (&hi)[2],
                                            float scale_log2,
                                            RowState<HD>& st) {
  static_assert(HD % 16 == 0 && BK % 16 == 0, "m16n8k16 tiles");
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  float s[BK / 8][4];
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;

  // S = Q K^T: one ldmatrix.x4 gives the B fragments of two 8-key tiles
  const int k_row = (lane & 7) + ((lane >> 4) << 3);
  const int k_col = ((lane >> 3) & 1) << 3;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < BK / 8; j += 2) {
      uint32_t b[4];
      ldmatrix_x4(b, k_s + (j * 8 + k_row) * stride + kk * 16 + k_col);
      mma_bf16(s[j], qf[kk], b[0], b[1]);
      mma_bf16(s[j + 1], qf[kk], b[2], b[3]);
    }
  }

  // masks, only where the tile crosses a row's [lo, hi] (a masked score
  // becomes -inf, whose exp2 is exactly 0), then the reference's
  // online-softmax step on each row with the scale folded into one FFMA
  // ahead of ex2
  const bool whole =
      k0 >= max(lo[0], lo[1]) && k0 + BK - 1 <= min(hi[0], hi[1]);
  if (!__all_sync(0xffffffffu, whole)) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        if (key < lo[r] || key > hi[r]) s[j][e] = minus_inf();
      }
  }
  float mx[2] = {minus_inf(), minus_inf()};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
  float m_safe[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(st.m[r], mx[r] * scale_log2);
    m_safe[r] = m_new <= kNegInf ? 0.f : m_new;
    alpha[r] = st.m[r] <= kNegInf ? 0.f : ex2(st.m[r] - m_safe[r]);
    st.m[r] = m_new;
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const float p = ex2(fmaf(s[j][e], scale_log2, -m_safe[r]));
      s[j][e] = p;
      rs[r] += p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
    st.l[r] = st.l[r] * alpha[r] + rs[r];
  }
  if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll  // (most tiles of a long row leave every max where it was)
    for (int i = 0; i < HD / 8; ++i) {
      st.acc[i][0] *= alpha[0];
      st.acc[i][1] *= alpha[0];
      st.acc[i][2] *= alpha[1];
      st.acc[i][3] *= alpha[1];
    }
  }

  // O += P V: P's accumulator layout is the A fragment's; V through
  // ldmatrix.trans gives the B fragments of two 8-column tiles at once
  const int v_row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int v_col = (lane >> 4) << 3;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint32_t hi_a[4], lo_a[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* pe = &s[2 * kk + (e >> 1)][2 * (e & 1)];
      split_bf16(pe[0], pe[1], hi_a[e], lo_a[e]);
    }
#pragma unroll
    for (int i = 0; i < HD / 8; i += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, v_s + (kk * 16 + v_row) * stride + i * 8 + v_col);
      mma_bf16(st.acc[i], hi_a, b[0], b[1]);
      mma_bf16(st.acc[i + 1], hi_a, b[2], b[3]);
      mma_bf16(st.acc[i], lo_a, b[0], b[1]);
      mma_bf16(st.acc[i + 1], lo_a, b[2], b[3]);
    }
  }
}

}  // namespace attn
