// Matmul against complementary-sparse packed weights, decompressed on the
// fly, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel kernels/packed_matmul.py:_packed_matmul_kernel
// of the JAX package (launched by packed_matmul). It computes
//
//   out[b, g*N + s] = sum_p packed[g, p, s] * x[b, p*N + route[g / R, p, s]]
//
// that is x @ decompress(packed, route) with no dense weight anywhere: the
// paper's Multiply-Route-Sum, 2*B*P*G*N = 2*B*D_in*D_out/N flops.
// x (B, P*N) f32 or bf16; packed (G, P, N) f32 or bf16, the layers' own
// layout; route (G/R, P, N) int8, read in place (never transposed or
// repeated out to G); out (B, G*N) f32. A route entry outside [0, N)
// selects no input and adds nothing, as in the TPU kernel.
//
// What bounds it: bytes, at decode and prefill batches. smollm-360m's up
// projection over 128 tokens in bf16 (B=128, P=240, G=640, N=4, R=G) moves
// ~2.79 MB, ~0.83 us at 3.35 TB/s, for 0.157 GFLOP (~0.16 us at the bf16
// tensor-core rate; this kernel runs on the f32 CUDA cores, ~2.3 us).
//
// Design (simple and correct first): the TPU kernel expands each packed tile
// into a dense (bp*N, bg*N) tile to feed its matrix unit, N times the
// multiply-adds the function needs. Here each thread computes its outputs
// directly. A block owns 16 rows x 32 groups (each group's N slots). Per
// chunk of 64 inputs (64/N partitions) it stages the rows' inputs, and the
// groups' weights and routes transposed (padded against bank conflicts), in
// shared memory as f32/int, all of the chunk's global loads in flight at
// once; thread (lane, warp) owns group lane and rows warp and warp+8, with
// N f32 accumulators each. Each weight multiplies the
// staged input its route picks; at R=G all lanes pick the same word, a
// broadcast. Ragged B, P and G edges are staged as zeros, so no shape needs
// to divide a tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 16;    // batch rows per block
constexpr int kGroups = 32;  // groups per block, one per lane
constexpr int kWarps = 8;    // warp w owns rows w and w + 8
constexpr int kRowsPerThread = kRows / kWarps;
constexpr int kCols = 64;    // inputs (partitions * N) staged per chunk
constexpr int kThreads = kGroups * kWarps;
constexpr int kXLoads = kRows * kCols / kThreads;    // inputs each thread stages
constexpr int kWLoads = kGroups * kCols / kThreads;  // weights each thread stages
static_assert(kThreads % kCols == 0 && kRows % (kThreads / kCols) == 0 &&
                  kGroups % (kThreads / kCols) == 0,
              "a chunk stages in whole rounds of the block, one column a thread");

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename TX, typename TW, int N>
__global__ void __launch_bounds__(kThreads)
packed_matmul_kernel(const TX* __restrict__ x, const TW* __restrict__ packed,
                     const int8_t* __restrict__ route, float* __restrict__ out, int B,
                     int P, int G, int R) {
  constexpr int kParts = kCols / N;  // partitions per chunk
  __shared__ float sh_x[kRows][kCols];
  __shared__ float sh_w[kCols][kGroups + 1];
  __shared__ int sh_r[kCols][kGroups + 1];

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tid = warp * kGroups + lane;
  const int g0 = blockIdx.x * kGroups;
  const int b0 = blockIdx.y * kRows;
  const int d_in = P * N;

  float acc[kRowsPerThread][N];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int s = 0; s < N; ++s) acc[i][s] = 0.f;

  // Thread tid stages column tid % kCols of every chunk, for the rows (of
  // x) and the groups (of packed and route) tid / kCols + j * kStride; the
  // route row of each of its groups is found once, outside the chunk loop.
  constexpr int kStride = kThreads / kCols;
  const int c = tid % kCols;
  const int first = tid / kCols;
  size_t route_row[kWLoads];
#pragma unroll
  for (int j = 0; j < kWLoads; ++j)
    route_row[j] = static_cast<size_t>(min(g0 + first + j * kStride, G - 1) / R) * d_in;

  for (int c0 = 0; c0 < d_in; c0 += kCols) {
    // Every global load of the chunk is issued before the first shared
    // store, so their latencies overlap instead of adding up.
    const int col = c0 + c;
    float stage_x[kXLoads], stage_w[kWLoads];
    int stage_r[kWLoads];
#pragma unroll
    for (int j = 0; j < kXLoads; ++j) {
      const int b = b0 + first + j * kStride;
      stage_x[j] = (b < B && col < d_in) ? to_float(x[static_cast<size_t>(b) * d_in + col]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kWLoads; ++j) {
      const int g = g0 + first + j * kStride;
      const bool in = g < G && col < d_in;
      const int r = in ? route[route_row[j] + col] : -1;
      const float w = in ? to_float(packed[static_cast<size_t>(g) * d_in + col]) : 0.f;
      const bool hit = r >= 0 && r < N;  // a route outside [0, N) adds nothing
      stage_w[j] = hit ? w : 0.f;
      stage_r[j] = hit ? r : 0;
    }
    __syncthreads();  // the previous chunk is fully consumed
#pragma unroll
    for (int j = 0; j < kXLoads; ++j) sh_x[first + j * kStride][c] = stage_x[j];
#pragma unroll
    for (int j = 0; j < kWLoads; ++j) {
      sh_w[c][first + j * kStride] = stage_w[j];
      sh_r[c][first + j * kStride] = stage_r[j];
    }
    __syncthreads();
#pragma unroll
    for (int pp = 0; pp < kParts; ++pp) {
      float w[N];
      int src[N];
#pragma unroll
      for (int s = 0; s < N; ++s) {
        w[s] = sh_w[pp * N + s][lane];
        src[s] = pp * N + sh_r[pp * N + s][lane];
      }
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float* xr = sh_x[warp + i * kWarps];
#pragma unroll
        for (int s = 0; s < N; ++s) acc[i][s] += w[s] * xr[src[s]];
      }
    }
  }

  const int g = g0 + lane;
  if (g >= G) return;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int b = b0 + warp + i * kWarps;
    if (b >= B) continue;
    float* o = out + static_cast<size_t>(b) * G * N + static_cast<size_t>(g) * N;
#pragma unroll
    for (int s = 0; s < N; ++s) o[s] = acc[i][s];
  }
}

template <typename TX, typename TW, int N>
cudaError_t launch(const void* x, const void* packed, const void* route, void* out, int B, int P,
                   int G, int R, cudaStream_t stream) {
  const dim3 grid((G + kGroups - 1) / kGroups, (B + kRows - 1) / kRows);
  const dim3 block(kGroups, kWarps);
  packed_matmul_kernel<TX, TW, N><<<grid, block, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(packed),
      static_cast<const int8_t*>(route), static_cast<float*>(out), B, P, G, R);
  return cudaGetLastError();
}

template <typename TX, typename TW>
cudaError_t launch_n(const void* x, const void* packed, const void* route, void* out, int B,
                     int P, int G, int N, int R, cudaStream_t stream) {
  switch (N) {
    case 1: return launch<TX, TW, 1>(x, packed, route, out, B, P, G, R, stream);
    case 2: return launch<TX, TW, 2>(x, packed, route, out, B, P, G, R, stream);
    case 4: return launch<TX, TW, 4>(x, packed, route, out, B, P, G, R, stream);
    case 8: return launch<TX, TW, 8>(x, packed, route, out, B, P, G, R, stream);
    case 16: return launch<TX, TW, 16>(x, packed, route, out, B, P, G, R, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// x_bf16 / packed_bf16: 1 when that operand holds bf16, 0 when it holds f32.
extern "C" int packed_matmul_launch(const void* x, int x_bf16, const void* packed,
                                    int packed_bf16, const void* route, void* out, int B, int P,
                                    int G, int N, int R, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_bf16 && packed_bf16)
    err = launch_n<__nv_bfloat16, __nv_bfloat16>(x, packed, route, out, B, P, G, N, R, st);
  else if (x_bf16)
    err = launch_n<__nv_bfloat16, float>(x, packed, route, out, B, P, G, N, R, st);
  else if (packed_bf16)
    err = launch_n<float, __nv_bfloat16>(x, packed, route, out, B, P, G, N, R, st);
  else
    err = launch_n<float, float>(x, packed, route, out, B, P, G, N, R, st);
  return static_cast<int>(err);
}

extern "C" const char* packed_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
