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
// What held the first version back (one block a row, four steps): three
// passes over the row in device memory (min/max, quantize-and-count, mask),
// each a chain of ten 2-byte scalar loads a thread; all 256 threads adding
// into one 256-bin histogram, where a Gaussian row crowds the middle bins;
// and one 8-warp block a row, 128 blocks, with little to hide the latency.
// Cold read 1.27x warm: latency, not bytes.
//
// Design: still one block a row (grid B), now of 10 warps, reading the row
// once:
// - Register path, for rows of at most 20 KB (10240 bf16, 5120 f32) whose
//   base and length are multiples of 16 bytes: each thread loads up to 4
//   16-byte vectors (vector i of the row to thread i mod 320, so a warp reads
//   512 B at once) into registers; takes the min and max from them; quantizes
//   each element once and keeps its bin in registers (4 bins a 32-bit word);
//   and after the threshold masks the vectors in registers and writes them
//   with 16-byte stores. A (128, 2560) bf16 row is 320 vectors, one a thread:
//   with 8 warps a quarter of the threads loaded, counted and stored two.
// - Each warp counts into its own 256-bin histogram in shared memory (10 x
//   256 counters), so a shared-memory atomic contends only within its warp;
//   the ten are added bin by bin before the one-warp tail scan for t.
// - Other rows (longer, or not 16-byte aligned, such as 1500 bf16 = 3000 B)
//   take the same kernel's plain-load loop, picked by the `in_registers` flag
//   of kwta_hist.py:register_path: three passes of scalar loads, the second
//   and third served by L1/L2, so no D is too long for the block.
// - Not done: splitting a row over a cluster of 2-4 blocks. The register path
//   issues the whole row's loads at once, one round trip, and what follows
//   is a few hundred cycles of on-chip work; a split would add two cluster
//   barriers and a merge of min/max and histograms through distributed
//   shared memory to save part of that on-chip work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 320;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr int kBinsPerLane = kBins / 32;
constexpr int kVecs = 4;  // 16-byte vectors a thread holds on the register path
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() { return __float2bfloat16(0.f); }

// Element h of a 32-bit word that holds 4 / sizeof(T) elements, as float.
template <typename T>
__device__ __forceinline__ float word_elem(uint32_t w, int h) {
  if constexpr (sizeof(T) == 4) return __uint_as_float(w);
  else return __uint_as_float(h ? (w & 0xffff0000u) : (w << 16));
}

// (int) clamp((v - lo) * scale, 0, 255), each step rounded as IEEE float32.
__device__ __forceinline__ int quantize(float v, float lo, float scale) {
  const float q = __fmul_rn(__fsub_rn(v, lo), scale);
  return static_cast<int>(fminf(fmaxf(q, 0.f), static_cast<float>(kBins - 1)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
kwta_hist_kernel(const T* __restrict__ x, T* __restrict__ y, int D, int K, int in_registers) {
  constexpr int kPerWord = 4 / static_cast<int>(sizeof(T));  // elements a word
  constexpr int kPerVec = 4 * kPerWord;                       // elements a vector
  __shared__ int hist[kWarps][kBins];
  __shared__ float sh_lo[kWarps];
  __shared__ float sh_hi[kWarps];
  __shared__ int sh_t;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const T* xr = x + static_cast<size_t>(blockIdx.x) * D;
  T* yr = y + static_cast<size_t>(blockIdx.x) * D;
  const int n_vecs = D / kPerVec;  // on the register path D is a whole number of vectors

  // 1. the row (into registers, or a first pass) and its min and max
  for (int i = tid; i < kWarps * kBins; i += kThreads) (&hist[0][0])[i] = 0;
  uint32_t w[kVecs][4];
  float lo = INFINITY, hi = -INFINITY;
  if (in_registers) {
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int i = tid + j * kThreads;
      const uint4 v = i < n_vecs ? reinterpret_cast<const uint4*>(xr)[i] : make_uint4(0, 0, 0, 0);
      w[j][0] = v.x, w[j][1] = v.y, w[j][2] = v.z, w[j][3] = v.w;
      if (i < n_vecs) {
#pragma unroll
        for (int e = 0; e < kPerVec; ++e) {
          const float f = word_elem<T>(w[j][e / kPerWord], e % kPerWord);
          lo = fminf(lo, f);
          hi = fmaxf(hi, f);
        }
      }
    }
  } else {
    for (int i = tid; i < D; i += kThreads) {
      const float v = to_float(xr[i]);
      lo = fminf(lo, v);
      hi = fmaxf(hi, v);
    }
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
  for (int v = 1; v < kWarps; ++v) {
    lo = fminf(lo, sh_lo[v]);
    hi = fmaxf(hi, sh_hi[v]);
  }
  const float scale =
      hi > lo ? __fdiv_rn(static_cast<float>(kBins - 1), __fsub_rn(hi, lo)) : 0.f;

  // 2. quantize once and count into the warp's own histogram
  int* my_hist = hist[warp];
  uint32_t bins[kVecs][kPerVec / 4];  // 4 bins a word
  if (in_registers) {
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
#pragma unroll
      for (int q = 0; q < kPerVec / 4; ++q) bins[j][q] = 0;
      if (tid + j * kThreads < n_vecs) {
#pragma unroll
        for (int e = 0; e < kPerVec; ++e) {
          const int bin = quantize(word_elem<T>(w[j][e / kPerWord], e % kPerWord), lo, scale);
          atomicAdd(&my_hist[bin], 1);
          bins[j][e / 4] |= static_cast<uint32_t>(bin) << (8 * (e % 4));
        }
      }
    }
  } else {
    for (int i = tid; i < D; i += kThreads) atomicAdd(&my_hist[quantize(to_float(xr[i]), lo, scale)], 1);
  }
  __syncthreads();
  // the warps' histograms, bin by bin, into the first
  for (int bin = tid; bin < kBins; bin += kThreads) {
    int c = 0;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) c += hist[v][bin];
    hist[0][bin] = c;
  }
  __syncthreads();

  // 3. one warp: lane l holds bins [8l, 8l+8); the tail count #(q >= t)
  //    above its bins is the sum of the higher lanes' counts
  if (warp == 0) {
    int c[kBinsPerLane];
    int mine = 0;
#pragma unroll
    for (int j = 0; j < kBinsPerLane; ++j) {
      c[j] = hist[0][lane * kBinsPerLane + j];
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
  if (in_registers) {
    constexpr uint32_t kElemMask = kPerWord == 1 ? 0xffffffffu : 0xffffu;
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int i = tid + j * kThreads;
      if (i >= n_vecs) continue;
      uint32_t out[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t keep = 0;
#pragma unroll
        for (int h = 0; h < kPerWord; ++h) {
          const int e = q * kPerWord + h;
          if (static_cast<int>((bins[j][e / 4] >> (8 * (e % 4))) & 0xffu) >= t)
            keep |= kElemMask << (32 / kPerWord * h);
        }
        out[q] = w[j][q] & keep;
      }
      reinterpret_cast<uint4*>(yr)[i] = make_uint4(out[0], out[1], out[2], out[3]);
    }
  } else {
    for (int i = tid; i < D; i += kThreads) {
      const T v = xr[i];
      yr[i] = quantize(to_float(v), lo, scale) >= t ? v : zero<T>();
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, void* y, int B, int D, int K, int in_registers,
                   cudaStream_t stream) {
  kwta_hist_kernel<T><<<B, kThreads, 0, stream>>>(static_cast<const T*>(x), static_cast<T*>(y),
                                                  D, K, in_registers);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// x_bf16: 1 when x and y hold bf16, 0 when they hold f32. in_registers: the
// register path (rows of at most 20 KB, base and length multiples of 16
// bytes); 0: the plain-load loop, for any row.
extern "C" int kwta_hist_launch(const void* x, int x_bf16, void* y, int B, int D, int K,
                                int in_registers, void* stream) {
  const long long row = static_cast<long long>(D) * (x_bf16 ? 2 : 4);
  if (in_registers && (row % 16 || row > kThreads * kVecs * 16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = x_bf16 ? launch<__nv_bfloat16>(x, y, B, D, K, in_registers, st)
                                 : launch<float>(x, y, B, D, K, in_registers, st);
  return static_cast<int>(err);
}

extern "C" const char* kwta_hist_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
