// A seeded fault for the linter's self-test, for Hopper (sm_90a): an
// off-by-one sparse-sparse gather.
//
// Replaces the Pallas TPU kernel analysis/lint.py:_oob_gather_kernel of the
// JAX package (launched by `bad` in _regression_oob_gather). For each row b
// of B and each output element e of a packed partition row (G x N values):
//
//   out[b, e] = sum_j vals[b, j] * packed[pidx[b, j] + 1, e]
//
// vals (B, K) f32, pidx (B, K) int32 declared in [0, P), packed (P, G, N)
// f32, out (B, G*N) f32. THE FAULT IS THE POINT: the row fetched is one past
// the partition the index names, with no clamp, so pidx = P - 1 reads the
// row after the end of packed. The Pallas kernel in interpret mode clamps
// that read to row P - 1; this kernel reads whatever lies there. The linter
// launches it only with in-range indices, or with packed inside guard bands
// (repro_torch/analysis/kernel_checks.py), where the stray read lands on a
// guard and names in[2].
//
// What bounds it: nothing worth a design; a simple CUDA-core body. One block
// a row, one thread an output element, the K entries summed in order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void oob_gather_kernel(const float* __restrict__ vals, const int* __restrict__ pidx,
                                  const float* __restrict__ packed, float* __restrict__ out,
                                  int K, int row) {
  const int b = blockIdx.x;
  for (int e = threadIdx.x; e < row; e += blockDim.x) {
    float acc = 0.f;
    for (int j = 0; j < K; ++j) {
      // the seeded off-by-one: partition pidx + 1, unclamped
      const long long p = static_cast<long long>(pidx[b * K + j]) + 1;
      acc += packed[p * row + e] * vals[b * K + j];
    }
    out[static_cast<size_t>(b) * row + e] = acc;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// row = G * N; threads a block as oob_gather_threads gives them.
extern "C" int oob_gather_launch(const void* vals, const void* pidx, const void* packed,
                                 void* out, int B, int K, int row, int threads, void* stream) {
  if (B < 1 || K < 1 || row < 1 || threads < 32 || threads > 1024 || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  oob_gather_kernel<<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int*>(pidx),
      static_cast<const float*>(packed), static_cast<float*>(out), K, row);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* oob_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
