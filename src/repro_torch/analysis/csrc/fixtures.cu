// The reference kernel verifier's fixture kernels, for Hopper (sm_90a): five
// small templated families, clean and faulty, that the port's guarded-launch
// harness (repro_torch/analysis/kernel_checks.py) must judge as the
// reference's static verifier judges their Pallas bodies.
//
// Replaces the Pallas TPU kernels of the JAX package's verifier tests
// (none is on a path of the system; they are fixtures):
//
//   gather<OFF>       tests/test_kernel_rules.py:_gather_kernel(off) (:85),
//                     called by _gather_call (:70, pallas_call :72).
//                     out[b, e] = sum_j vals[b, j] * packed[pidx[b, j] + OFF, e];
//                     OFF = 1 reads one partition past the last (in[2]).
//   induction<OFF>    the fori_loop fixtures ok / bad (:134 / :139, call :146).
//                     out[c] = sum_{j < n} x[j + OFF, c]; OFF = 1 reads row n (in[0]).
//   accum<MODE>       _accum_call (:163, call :165) with the kernels at :179,
//                     :191, :202, :214: over the grid (S, 1, 1, nk) of 8x8
//                     blocks, out[s] accumulates x[s, :, kb] @ w[s, kb, :] over
//                     the nk K blocks kb. MODE 0 zero-stores at kb = 0 first;
//                     MODE 1 adds with no zero-store (reads out before writing
//                     it, out[2]); MODE 2 overwrites (last writer wins).
//   pad<MASKED>       _pad_call (:226, call :228) with :238, :247, :257:
//                     out = x * 2 over blocks of 4 rows. Unmasked, the last
//                     block of a ragged row count reads and writes the rows
//                     past the end (CUDA has no block store that drops them);
//                     masked, it touches rows < rows only.
//   copy_scratch      _scratch_call (:268, call :275) and the whole-array copy
//                     of tests/test_analysis.py (_copy_kernel :171, `big`
//                     :178-183): a copy staged through a dynamic shared-memory
//                     scratch of the fixture's size. Sizes past the card's
//                     227 KB are refused here as the launch would be; the
//                     linter finds them from the geometry before any launch.
//
// All operands f32 (indices int32), contiguous; shapes are the reference's.
// What bounds them: nothing worth a design (a few hundred bytes each, launch
// latency); simple CUDA-core bodies, one block per row / slot / row block /
// copy and one thread per output element, sums in a fixed order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDynamicSmem = 227 * 1024;

template <int OFF>
__global__ void gather_kernel(const float* __restrict__ vals, const int* __restrict__ pidx,
                              const float* __restrict__ packed, float* __restrict__ out, int K,
                              int row) {
  const int b = blockIdx.x;
  for (int e = threadIdx.x; e < row; e += blockDim.x) {
    float acc = 0.f;
    for (int j = 0; j < K; ++j) {
      const long long p = static_cast<long long>(pidx[b * K + j]) + OFF;
      acc += packed[p * row + e] * vals[b * K + j];
    }
    out[static_cast<size_t>(b) * row + e] = acc;
  }
}

template <int OFF>
__global__ void induction_kernel(const float* __restrict__ x, float* __restrict__ out, int n,
                                 int C) {
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float acc = 0.f;
    for (int j = 0; j < n; ++j) acc += x[(j + OFF) * C + c];
    out[c] = acc;
  }
}

// x (S, M, Kx) with row stride Kx, w (S, Kx, C); nk blocks of bk along K.
template <int MODE>
__global__ void accum_kernel(const float* __restrict__ x, const float* __restrict__ w, float* out,
                             int M, int Kx, int C, int bk, int nk) {
  const int s = blockIdx.x;
  const float* xs = x + static_cast<size_t>(s) * M * Kx;
  const float* ws = w + static_cast<size_t>(s) * Kx * C;
  float* o = out + static_cast<size_t>(s) * M * C;
  for (int e = threadIdx.x; e < M * C; e += blockDim.x) {
    const int i = e / C, j = e % C;
    for (int kb = 0; kb < nk; ++kb) {
      float dot = 0.f;
      for (int k = kb * bk; k < (kb + 1) * bk; ++k) dot += xs[i * Kx + k] * ws[k * C + j];
      if (MODE == 0 && kb == 0) o[e] = 0.f;  // the zero-store before the first +=
      if (MODE == 2)
        o[e] = dot;  // last writer wins
      else
        o[e] = o[e] + dot;
    }
  }
}

// One block a block of `block` rows; a thread an element of the tile.
template <bool MASKED>
__global__ void pad_kernel(const float* __restrict__ x, float* __restrict__ out, int rows, int C,
                           int block) {
  for (int t = threadIdx.x; t < block * C; t += blockDim.x) {
    const int r = blockIdx.x * block + t / C, c = t % C;
    if (MASKED && r >= rows) continue;
    out[r * C + c] = x[r * C + c] * 2.f;
  }
}

__global__ void copy_scratch_kernel(const float* __restrict__ x, float* __restrict__ out, int n) {
  extern __shared__ float scratch[];
  for (int i = threadIdx.x; i < n; i += blockDim.x) scratch[i] = x[i];
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) out[i] = scratch[i];
}

bool bad_threads(int threads) { return threads < 32 || threads > 1024 || threads % 32; }

cudaError_t last() { return cudaGetLastError(); }

}  // namespace

// Each launcher launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 on success); threads a block as the Python
// *_geometry functions of repro_torch/analysis/fixtures.py give them.

extern "C" int gather_launch(int off, const void* vals, const void* pidx, const void* packed,
                             void* out, int B, int K, int row, int threads, void* stream) {
  if (B < 1 || K < 1 || row < 1 || bad_threads(threads) || (off != 0 && off != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto v = static_cast<const float*>(vals);
  auto p = static_cast<const int*>(pidx);
  auto w = static_cast<const float*>(packed);
  auto o = static_cast<float*>(out);
  if (off)
    gather_kernel<1><<<B, threads, 0, s>>>(v, p, w, o, K, row);
  else
    gather_kernel<0><<<B, threads, 0, s>>>(v, p, w, o, K, row);
  return static_cast<int>(last());
}

extern "C" int induction_launch(int off, const void* x, void* out, int n, int C, int threads,
                                void* stream) {
  if (n < 1 || C < 1 || bad_threads(threads) || (off != 0 && off != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto xi = static_cast<const float*>(x);
  auto o = static_cast<float*>(out);
  if (off)
    induction_kernel<1><<<1, threads, 0, s>>>(xi, o, n, C);
  else
    induction_kernel<0><<<1, threads, 0, s>>>(xi, o, n, C);
  return static_cast<int>(last());
}

extern "C" int accum_launch(int mode, const void* x, const void* w, void* out, int S, int M,
                            int Kx, int C, int bk, int nk, int threads, void* stream) {
  if (S < 1 || M < 1 || C < 1 || bk < 1 || nk < 1 || nk * bk > Kx || bad_threads(threads) ||
      mode < 0 || mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto xi = static_cast<const float*>(x);
  auto wi = static_cast<const float*>(w);
  auto o = static_cast<float*>(out);
  if (mode == 0)
    accum_kernel<0><<<S, threads, 0, s>>>(xi, wi, o, M, Kx, C, bk, nk);
  else if (mode == 1)
    accum_kernel<1><<<S, threads, 0, s>>>(xi, wi, o, M, Kx, C, bk, nk);
  else
    accum_kernel<2><<<S, threads, 0, s>>>(xi, wi, o, M, Kx, C, bk, nk);
  return static_cast<int>(last());
}

extern "C" int pad_launch(int masked, const void* x, void* out, int rows, int C, int block,
                          int threads, void* stream) {
  if (rows < 1 || C < 1 || block < 1 || bad_threads(threads))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const int blocks = (rows + block - 1) / block;
  auto xi = static_cast<const float*>(x);
  auto o = static_cast<float*>(out);
  if (masked)
    pad_kernel<true><<<blocks, threads, 0, s>>>(xi, o, rows, C, block);
  else
    pad_kernel<false><<<blocks, threads, 0, s>>>(xi, o, rows, C, block);
  return static_cast<int>(last());
}

extern "C" int copy_scratch_launch(const void* x, void* out, int n, int smem_bytes, int threads,
                                   void* stream) {
  if (n < 1 || bad_threads(threads) || smem_bytes < n * static_cast<int>(sizeof(float)) ||
      smem_bytes > kMaxDynamicSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(copy_scratch_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  copy_scratch_kernel<<<1, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n);
  return static_cast<int>(last());
}

#define FIXTURE_ERROR_STRING(name)                          \
  extern "C" const char* name##_error_string(int code) {    \
    return cudaGetErrorString(static_cast<cudaError_t>(code)); \
  }
FIXTURE_ERROR_STRING(gather)
FIXTURE_ERROR_STRING(induction)
FIXTURE_ERROR_STRING(accum)
FIXTURE_ERROR_STRING(pad)
FIXTURE_ERROR_STRING(copy_scratch)
