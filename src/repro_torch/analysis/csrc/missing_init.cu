// A seeded fault for the linter's self-test, for Hopper (sm_90a): a grouped
// accumulation with its zero-store dropped.
//
// Replaces the Pallas TPU kernel analysis/lint.py:_missing_init_kernel of
// the JAX package (launched by `bad` in _regression_missing_init). For each
// slot s of S, over the K axis in steps of `bk` (the Pallas grid's last
// axis, 2 steps of 8 at the seeded shape):
//
//   out[s] += xg[s, :, k0:k0+bk] @ packed[s, k0:k0+bk, :]
//
// xg (S, M, K) f32, packed (S, K, C) f32, out (S, M, C) f32. THE FAULT IS
// THE POINT: nothing stores zeros into out before the first step, so the
// result adds to whatever the buffer held (the Pallas kernel in interpret
// mode returns all NaN). The linter catches it by launching it twice, on an
// out pre-filled with NaN and with a finite pattern
// (repro_torch/analysis/kernel_checks.py): the two results differ, out[2].
//
// What bounds it: nothing worth a design; a simple CUDA-core body. One
// block a slot, one thread an output element, each K step a read, a sum
// over its bk inputs and a write of out.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void missing_init_kernel(const float* __restrict__ xg,
                                    const float* __restrict__ packed, float* out, int M, int K,
                                    int C, int bk) {
  const int s = blockIdx.x;
  const float* x = xg + static_cast<size_t>(s) * M * K;
  const float* w = packed + static_cast<size_t>(s) * K * C;
  float* o = out + static_cast<size_t>(s) * M * C;
  for (int e = threadIdx.x; e < M * C; e += blockDim.x) {
    const int i = e / C, j = e % C;
    for (int k0 = 0; k0 < K; k0 += bk) {
      // the seeded fault: no o[e] = 0 at k0 == 0 before the first +=
      float acc = o[e];
      for (int k = k0; k < k0 + bk && k < K; ++k) acc += x[i * K + k] * w[k * C + j];
      o[e] = acc;
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int missing_init_launch(const void* xg, const void* packed, void* out, int S, int M,
                                   int K, int C, int bk, int threads, void* stream) {
  if (S < 1 || M < 1 || K < 1 || C < 1 || bk < 1 || threads < 32 || threads > 1024 ||
      threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  missing_init_kernel<<<S, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xg), static_cast<const float*>(packed),
      static_cast<float*>(out), M, K, C, bk);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* missing_init_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
