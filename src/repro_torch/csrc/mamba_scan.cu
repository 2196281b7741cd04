// Mamba1 selective scan for Hopper (sm_90a): the prefill / append scan of
// the SSM serving path.
//
// Replaces the TPU kernel src/repro/kernels/mamba_scan.py::mamba_scan_bdn
// (Pallas; body _scan_kernel). Same contract: da / dbx (b, s, di, n) and
// cmat (b, s, n) in one dtype (fp32 or bf16), h0 (b, di, n) fp32;
//   h_t = da_t * h_{t-1} + dbx_t,   y_t = sum_n h_t * C_t,
// y (b, s, di) in da's dtype, h_out (b, di, n) fp32 the state after the
// last step. State and accumulation are fp32.
//
// What bounds it on this card: bytes. Every (t, channel, state) element of
// da and dbx is read once and used for 2 FMAs (4 FLOP), so at the serving
// path's largest shape (b 2, s 512, di 8192, n 16, fp32) the 1.07 GB of
// da + dbx take 0.32 ms at 3.35 TB/s while the arithmetic takes 8 us at
// fp32's 67 TFLOP/s. The design is about keeping enough loads in flight:
//   * the Pallas grid's sequential time-chunk axis (with its VMEM carry and
//     padding to a multiple of the chunk) becomes a loop over all s steps
//     inside each thread, so there is no padding and no cross-block carry;
//   * a channel's n states are split over n / 4 neighbouring lanes, 4
//     states each, so a thread loads one 16-byte float4 (8 bytes for bf16)
//     of da and of dbx per step and a warp reads 512 contiguous bytes;
//     y_t is the sum over those lanes (a log2(n / 4)-step xor shuffle,
//     off the recurrence's dependency chain). At the serving shape that is
//     65,536 threads, about 500 per SM;
//   * the time loop runs in groups of kUnroll steps with the next group's
//     da / dbx / C loaded into registers before the current group is
//     computed: the loads do not depend on h, so each thread keeps up to
//     2 * kUnroll steps in flight instead of waiting on every step's load;
//   * at most 128 registers a thread (__launch_bounds__ with kMinBlocks 4)
//     so 4 blocks fit an SM and the serving shape's 512 blocks run in one
//     wave; left free, nvcc took 136-151 registers, 3 blocks fit, and a
//     second wave of 116 blocks followed the first 396 (PERF.md: fp32
//     0.43 -> 0.40 ms, bf16 inputs 0.55 -> 0.33 ms);
//   * C arrives as a strided view (a split of x_proj's output): it is read
//     through its batch and time strides, 4 scalars per step, which the
//     warp's lanes share through L1.
// TMA / cp.async staging and fusing the ssm_inputs math (so the fp32
// (b, s, di, n) tensors are never written) are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMinBlocks = 4;  // resident blocks per SM (caps registers)
constexpr int kUnroll = 4;     // time steps per load group
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

// Four consecutive elements as fp32 (one 16-byte load, 8 for bf16).
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

struct Step {
  float4 a, b, c;  // da, dbx and C for this thread's 4 states
};

// One time step's inputs; a step past s is identity decay with no input.
template <typename T>
__device__ __forceinline__ Step load_step(const T* pa, const T* pb,
                                          const T* pc, int t, int s,
                                          int64_t step, int64_t c_step,
                                          bool live) {
  Step r;
  if (live && t < s) {
    r.a = load4(pa + t * step);
    r.b = load4(pb + t * step);
    const T* c = pc + t * c_step;
    r.c = make_float4(to_float(__ldg(c)), to_float(__ldg(c + 1)),
                      to_float(__ldg(c + 2)), to_float(__ldg(c + 3)));
  } else {
    r.a = make_float4(1.f, 1.f, 1.f, 1.f);
    r.b = make_float4(0.f, 0.f, 0.f, 0.f);
    r.c = r.b;
  }
  return r;
}

// Thread (chan, lane) owns states [4 * lane, 4 * lane + 4) of channel
// chan = row * di + c, for every time step.
template <typename T, int LANES>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    mamba_scan_kernel(const T* __restrict__ da, const T* __restrict__ dbx,
                      const T* __restrict__ cmat,
                      const float* __restrict__ h0, T* __restrict__ y,
                      float* __restrict__ h_out, int b, int s, int di,
                      int64_t c_stride_b, int64_t c_stride_t) {
  constexpr int N = 4 * LANES;  // d_state
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const bool live = tid < static_cast<int64_t>(b) * di * LANES;
  const int64_t chan = live ? tid / LANES : 0;
  const int lane = static_cast<int>(tid % LANES);
  const int64_t row = chan / di;
  const int64_t c = chan % di;
  const int64_t step = static_cast<int64_t>(di) * N;  // one time step
  const int64_t base = (row * s * di + c) * N + 4 * lane;
  const T* pa = da + base;
  const T* pb = dbx + base;
  const T* pc = cmat + row * c_stride_b + 4 * lane;
  T* py = y + row * s * di + c;

  float4 h = live ? load4(h0 + chan * N + 4 * lane)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  Step cur[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    cur[u] = load_step(pa, pb, pc, u, s, step, c_stride_t, live);
  for (int t0 = 0; t0 < s; t0 += kUnroll) {
    Step nxt[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)  // next group in flight
      nxt[u] = load_step(pa, pb, pc, t0 + kUnroll + u, s, step, c_stride_t,
                         live);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const Step& in = cur[u];
      h.x = fmaf(in.a.x, h.x, in.b.x);
      h.y = fmaf(in.a.y, h.y, in.b.y);
      h.z = fmaf(in.a.z, h.z, in.b.z);
      h.w = fmaf(in.a.w, h.w, in.b.w);
      float part = h.x * in.c.x + h.y * in.c.y + h.z * in.c.z +
                   h.w * in.c.w;
#pragma unroll
      for (int off = LANES / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(kFull, part, off);
      const int t = t0 + u;
      if (live && lane == 0 && t < s)
        py[static_cast<int64_t>(t) * di] = from_float<T>(part);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) cur[u] = nxt[u];
  }
  if (live) *reinterpret_cast<float4*>(h_out + chan * N + 4 * lane) = h;
}

template <typename T>
int launch(const void* da, const void* dbx, const void* cmat,
           const void* h0, void* y, void* h_out, int b, int s, int di, int n,
           int64_t c_stride_b, int64_t c_stride_t, cudaStream_t stream) {
  const int lanes = n / 4;
  const int64_t threads = static_cast<int64_t>(b) * di * lanes;
  const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads));
#define MAMBA_SCAN_LAUNCH(L)                                                 \
  mamba_scan_kernel<T, L><<<grid, kThreads, 0, stream>>>(                    \
      static_cast<const T*>(da), static_cast<const T*>(dbx),                 \
      static_cast<const T*>(cmat), static_cast<const float*>(h0),            \
      static_cast<T*>(y), static_cast<float*>(h_out), b, s, di, c_stride_b,  \
      c_stride_t);                                                           \
  break
  switch (n) {
    case 4: MAMBA_SCAN_LAUNCH(1);
    case 8: MAMBA_SCAN_LAUNCH(2);
    case 16: MAMBA_SCAN_LAUNCH(4);
    case 32: MAMBA_SCAN_LAUNCH(8);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MAMBA_SCAN_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry for ctypes. The caller (kernels/mamba_scan.py) checks
// shapes, dtypes, devices, contiguity and alignment, allocates y and h_out
// and passes PyTorch's current stream; cmat's strides are in elements (its
// last stride is 1). Returns the first CUDA error of the launch
// (cudaGetLastError() after it), 0 on success.
extern "C" int mamba_scan_fwd(const void* da, const void* dbx,
                              const void* cmat, const void* h0, void* y,
                              void* h_out, int b, int s, int di, int n,
                              long long c_stride_b, long long c_stride_t,
                              int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(da, dbx, cmat, h0, y, h_out, b, s, di, n,
                                 c_stride_b, c_stride_t, st);
  return launch<float>(da, dbx, cmat, h0, y, h_out, b, s, di, n, c_stride_b,
                       c_stride_t, st);
}
