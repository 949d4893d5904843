// Histogram-threshold global k-WTA for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel kernels/kwta_hist.py:_kwta_hist_kernel of
// the JAX package (launched by kwta_hist_pallas). For each row of x (B, D):
//
//   lo, hi = the row's min and max, in float32
//   scale  = 255 / (hi - lo), or 0 when hi == lo
//   q[d]   = (int) clamp((x[d] - lo) * scale, 0, 255)
//   t      = the largest bin with #(q >= t) >= K, or 0 when there is none
//   y[d]   = q[d] >= t ? x[d] : 0
//
// x and y are (B, D), both f32 or both bf16. The quantization is float32
// whatever the input type (a bf16 row is upcast first, as the TPU kernel
// does), with IEEE-rounded subtract, multiply and divide and no contraction
// into FMA, so every element lands in the TPU kernel's bin. K >= D keeps the
// whole row (t = 0). Inputs are assumed finite.
//
// What bounds it: bytes. The row is read once and written once, against a
// few operations per element. At (128, 2560) bf16 that is 1.31 MB, about
// 0.39 us at 3.35 TB/s.
//
// Design (simple and correct first): one block per row, since rows are
// independent and D is a few thousand. The TPU kernel counts 2x16 bins with
// vector compares because its VPU cannot scatter; Hopper has shared-memory
// atomics, so the paper's 256-bin histogram (Fig. 10) is built directly, in
// four steps: a block reduction for lo and hi; quantize and atomicAdd into
// 256 shared counters; one warp scans the counters from the top bin down for
// t; a masking pass writes the row. The masking pass quantizes again from a
// second read of the row, which L1/L2 serve, so no D is too long for the
// block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr int kBinsPerLane = kBins / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() { return __float2bfloat16(0.f); }

// (int) clamp((v - lo) * scale, 0, 255), each step rounded as IEEE float32.
__device__ __forceinline__ int quantize(float v, float lo, float scale) {
  const float q = __fmul_rn(__fsub_rn(v, lo), scale);
  return static_cast<int>(fminf(fmaxf(q, 0.f), static_cast<float>(kBins - 1)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
kwta_hist_kernel(const T* __restrict__ x, T* __restrict__ y, int D, int K) {
  __shared__ int hist[kBins];
  __shared__ float sh_lo[kWarps];
  __shared__ float sh_hi[kWarps];
  __shared__ int sh_t;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const T* xr = x + static_cast<size_t>(blockIdx.x) * D;
  T* yr = y + static_cast<size_t>(blockIdx.x) * D;

  // 1. the row's min and max
  for (int i = tid; i < kBins; i += kThreads) hist[i] = 0;
  float lo = INFINITY, hi = -INFINITY;
  for (int i = tid; i < D; i += kThreads) {
    const float v = to_float(xr[i]);
    lo = fminf(lo, v);
    hi = fmaxf(hi, v);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    lo = fminf(lo, __shfl_xor_sync(kFull, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(kFull, hi, off));
  }
  if (lane == 0) {
    sh_lo[warp] = lo;
    sh_hi[warp] = hi;
  }
  __syncthreads();
  lo = sh_lo[0];
  hi = sh_hi[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    lo = fminf(lo, sh_lo[w]);
    hi = fmaxf(hi, sh_hi[w]);
  }
  const float scale =
      hi > lo ? __fdiv_rn(static_cast<float>(kBins - 1), __fsub_rn(hi, lo)) : 0.f;

  // 2. quantize and count
  for (int i = tid; i < D; i += kThreads) atomicAdd(&hist[quantize(to_float(xr[i]), lo, scale)], 1);
  __syncthreads();

  // 3. one warp: lane l holds bins [8l, 8l+8); the tail count #(q >= t)
  //    above its bins is the sum of the higher lanes' counts
  if (warp == 0) {
    int c[kBinsPerLane];
    int mine = 0;
#pragma unroll
    for (int j = 0; j < kBinsPerLane; ++j) {
      c[j] = hist[lane * kBinsPerLane + j];
      mine += c[j];
    }
    int from_here = mine;  // counts of lanes >= lane
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const int v = __shfl_down_sync(kFull, from_here, off);
      if (lane + off < 32) from_here += v;
    }
    int tail = from_here - mine;
    int t = -1;
#pragma unroll
    for (int j = kBinsPerLane - 1; j >= 0; --j) {
      tail += c[j];
      if (t < 0 && tail >= K) t = lane * kBinsPerLane + j;
    }
    // tail counts fall as t rises: the largest qualifying bin over all lanes
#pragma unroll
    for (int off = 16; off > 0; off /= 2) t = max(t, __shfl_xor_sync(kFull, t, off));
    if (lane == 0) sh_t = max(t, 0);
  }
  __syncthreads();

  // 4. keep every element at or above the threshold bin
  const int t = sh_t;
  for (int i = tid; i < D; i += kThreads) {
    const T v = xr[i];
    yr[i] = quantize(to_float(v), lo, scale) >= t ? v : zero<T>();
  }
}

template <typename T>
cudaError_t launch(const void* x, void* y, int B, int D, int K, cudaStream_t stream) {
  kwta_hist_kernel<T><<<B, kThreads, 0, stream>>>(static_cast<const T*>(x), static_cast<T*>(y),
                                                  D, K);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// x_bf16: 1 when x and y hold bf16, 0 when they hold f32.
extern "C" int kwta_hist_launch(const void* x, int x_bf16, void* y, int B, int D, int K,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = x_bf16 ? launch<__nv_bfloat16>(x, y, B, D, K, st)
                                 : launch<float>(x, y, B, D, K, st);
  return static_cast<int>(err);
}

extern "C" const char* kwta_hist_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
