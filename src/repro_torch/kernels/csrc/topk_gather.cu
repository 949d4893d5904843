// Sparse-sparse complementary-sparse contraction for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel kernels/topk_gather.py:_topk_gather_kernel
// of the JAX package (launched by topk_gather_matmul). It computes, for
// every batch row b and output (g, s):
//
//   out[b, g*N + s] = sum_k vals[b,k] * packed_p[p_idx[b,k], g, s]
//                               * (route[g / R, p_idx[b,k], s] == s_off[b,k])
//
// vals (B,K) f32; p_idx, s_off (B,K) int32; packed_p (P,G,N) f32 or bf16,
// partition-major; route (G/R,P,N) int8, read in place (the route shared by
// R groups is never repeated out to G); out (B, G*N) f32.
//
// What bounds it: bytes. Every non-zero reads one partition row of G*N
// packed weights, so the card must move min(P, distinct partitions) rows
// of G*N weights, while the arithmetic is 2*B*K*G flops. At the decode
// shape of smollm-360m (B=4, K=320, P=640, G=240, N=4, R=G, bf16) that is
// at most 640*960*2 B ~ 1.2 MB, about 0.37 us at 3.35 TB/s, against ~0.6
// MFLOP: the kernel sits at launch latency, far above its byte floor.
//
// Design (simple and correct first): one block per (strip of 32 groups,
// batch row). The row's support is staged in shared memory in chunks; each
// warp of the block takes every kSlices-th non-zero, and each of its 32
// threads owns one group's N outputs with f32 accumulators, so a warp reads
// a partition row's strip of 32*N consecutive weights in one coalesced
// sweep. The warps' partial sums are added through shared memory. The
// block loop over K replaces the TPU kernel's sequential fori_loop; the
// weight strip that the TPU kept in VMEM across the batch is left to L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroupsPerBlock = 32;  // one warp-wide strip of groups
constexpr int kSlices = 8;           // warps per block; warp j takes k = j mod kSlices
constexpr int kChunk = 512;          // support entries staged in shared memory at once

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int N>
__global__ void __launch_bounds__(kGroupsPerBlock * kSlices)
topk_gather_kernel(const float* __restrict__ vals, const int* __restrict__ p_idx,
                   const int* __restrict__ s_off, const T* __restrict__ packed,
                   const int8_t* __restrict__ route, float* __restrict__ out,
                   int K, int P, int G, int R) {
  __shared__ float sh_val[kChunk];
  __shared__ int sh_p[kChunk];
  __shared__ int sh_s[kChunk];
  __shared__ float sh_part[kSlices][kGroupsPerBlock][N];

  const int b = blockIdx.y;
  const int lane = threadIdx.x;
  const int slice = threadIdx.y;
  const int tid = slice * kGroupsPerBlock + lane;
  const int g = blockIdx.x * kGroupsPerBlock + lane;
  const bool live = g < G;
  const size_t row = static_cast<size_t>(G) * N;  // one partition row of packed
  const T* w_g = packed + static_cast<size_t>(live ? g : 0) * N;
  const int8_t* r_g = route + static_cast<size_t>(live ? g / R : 0) * P * N;
  const size_t base = static_cast<size_t>(b) * K;

  float acc[N];
#pragma unroll
  for (int s = 0; s < N; ++s) acc[s] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kChunk) {
    const int kn = min(kChunk, K - k0);
    __syncthreads();  // the previous chunk is fully consumed
    for (int i = tid; i < kn; i += kGroupsPerBlock * kSlices) {
      sh_val[i] = vals[base + k0 + i];
      sh_p[i] = p_idx[base + k0 + i];
      sh_s[i] = s_off[base + k0 + i];
    }
    __syncthreads();
    if (live) {
#pragma unroll 4
      for (int i = slice; i < kn; i += kSlices) {
        const int p = sh_p[i];
        if (p < 0 || p >= P) continue;  // no partition there: contributes nothing
        const int so = sh_s[i];
        const float v = sh_val[i];
        const T* w = w_g + static_cast<size_t>(p) * row;
        const int8_t* r = r_g + static_cast<size_t>(p) * N;
#pragma unroll
        for (int s = 0; s < N; ++s)
          if (r[s] == so) acc[s] += v * to_float(w[s]);
      }
    }
  }

#pragma unroll
  for (int s = 0; s < N; ++s) sh_part[slice][lane][s] = acc[s];
  __syncthreads();
  if (slice == 0 && live) {
    float* out_g = out + static_cast<size_t>(b) * row + static_cast<size_t>(g) * N;
#pragma unroll
    for (int s = 0; s < N; ++s) {
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kSlices; ++j) sum += sh_part[j][lane][s];
      out_g[s] = sum;
    }
  }
}

template <typename T, int N>
cudaError_t launch(const void* vals, const void* p_idx, const void* s_off,
                   const void* packed, const void* route, void* out, int B, int K,
                   int P, int G, int R, cudaStream_t stream) {
  const dim3 grid((G + kGroupsPerBlock - 1) / kGroupsPerBlock, B);
  const dim3 block(kGroupsPerBlock, kSlices);
  topk_gather_kernel<T, N><<<grid, block, 0, stream>>>(
      static_cast<const float*>(vals), static_cast<const int*>(p_idx),
      static_cast<const int*>(s_off), static_cast<const T*>(packed),
      static_cast<const int8_t*>(route), static_cast<float*>(out), K, P, G, R);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_n(const void* vals, const void* p_idx, const void* s_off,
                     const void* packed, const void* route, void* out, int B, int K,
                     int P, int G, int N, int R, cudaStream_t stream) {
  switch (N) {
    case 1: return launch<T, 1>(vals, p_idx, s_off, packed, route, out, B, K, P, G, R, stream);
    case 2: return launch<T, 2>(vals, p_idx, s_off, packed, route, out, B, K, P, G, R, stream);
    case 4: return launch<T, 4>(vals, p_idx, s_off, packed, route, out, B, K, P, G, R, stream);
    case 8: return launch<T, 8>(vals, p_idx, s_off, packed, route, out, B, K, P, G, R, stream);
    case 16: return launch<T, 16>(vals, p_idx, s_off, packed, route, out, B, K, P, G, R, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// packed_bf16: 1 when packed_p holds bf16, 0 when it holds f32.
extern "C" int topk_gather_launch(const void* vals, const void* p_idx, const void* s_off,
                                  const void* packed, int packed_bf16, const void* route,
                                  void* out, int B, int K, int P, int G, int N, int R,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      packed_bf16 ? launch_n<__nv_bfloat16>(vals, p_idx, s_off, packed, route, out, B, K, P,
                                            G, N, R, st)
                  : launch_n<float>(vals, p_idx, s_off, packed, route, out, B, K, P, G, N, R,
                                    st);
  return static_cast<int>(err);
}

extern "C" const char* topk_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
