// Shared-route grouped complementary-sparse matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// kernels/grouped_cs_matmul.py:_grouped_cs_kernel of the JAX package
// (launched by grouped_cs_matmul). With one route shared by all groups, the
// routing is a static permutation of the activations (done outside), and
// what is left is N independent products, one per pack slot s:
//
//   out[s, b, g] = sum_p xg[s, b, p] * packed[s, p, g]
//
// xg (N, B, P) f32 or bf16; packed (N, P, G) f32 or bf16; out (N, B, G) f32,
// accumulated in f32 over f32 upcasts of the operands. 2*N*B*P*G =
// 2*B*D_in*D_out/N flops: the paper's N-fold cut in multiply-adds.
//
// What bounds it: bytes, at decode and prefill batches. At smollm-360m's up
// projection over 128 tokens in bf16 (N=4, B=128, P=240, G=640) it moves
// ~2.79 MB, ~0.83 us at 3.35 TB/s, for 0.157 GFLOP (~0.16 us at the bf16
// tensor-core rate; this kernel runs on the f32 CUDA cores, ~2.3 us).
//
// Design (simple and correct first): a shared-memory tiled product computed
// in the kernel's own body (no cuBLAS). A block owns a 32 x 64 tile of one
// slot's (B, G) output (blockIdx.z = s); per chunk of 16 partitions it
// stages the xg tile (transposed, padded against bank conflicts) and the
// packed tile in shared memory as f32, all of the chunk's global loads in
// flight at once; each of its 16 x 16 threads owns 2 x 4 outputs, rows
// ty + 16i and columns tx + 16j, so a warp reads two broadcast words of the
// xg tile and 16 consecutive words of the packed tile per step. Ragged B, P and G edges are staged as zeros: P = 240 at the up
// projection, which no power-of-two tile above 16 divides, runs as it is.
// A bf16 tensor-core product (mma.sync / wgmma) would compute the same up to
// the order of the sums; that is later speed work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTM = 32;  // rows (B) per block
constexpr int kTN = 64;  // columns (G) per block
constexpr int kTK = 16;  // partitions (P) per chunk
constexpr int kTX = 16;
constexpr int kTY = 16;
constexpr int kThreads = kTX * kTY;
constexpr int kRM = kTM / kTY;  // rows per thread
constexpr int kRN = kTN / kTX;  // columns per thread
constexpr int kALoads = kTM * kTK / kThreads;  // xg values each thread stages
constexpr int kBLoads = kTK * kTN / kThreads;  // packed values each thread stages
static_assert(kTM * kTK % kThreads == 0 && kTK * kTN % kThreads == 0,
              "a chunk stages in whole rounds of the block");

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
grouped_cs_kernel(const TX* __restrict__ xg, const TW* __restrict__ packed,
                  float* __restrict__ out, int B, int P, int G) {
  __shared__ float sh_a[kTK][kTM + 1];  // xg tile, [p][b]
  __shared__ float sh_b[kTK][kTN];      // packed tile, [p][g]

  const int s = blockIdx.z;
  const int b0 = blockIdx.y * kTM;
  const int g0 = blockIdx.x * kTN;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTX + tx;
  const TX* a = xg + static_cast<size_t>(s) * B * P;
  const TW* w = packed + static_cast<size_t>(s) * P * G;

  float acc[kRM][kRN];
#pragma unroll
  for (int i = 0; i < kRM; ++i)
#pragma unroll
    for (int j = 0; j < kRN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < P; k0 += kTK) {
    // Every global load of the chunk is issued before the first shared
    // store, so their latencies overlap instead of adding up.
    float stage_a[kALoads], stage_b[kBLoads];
#pragma unroll
    for (int j = 0; j < kALoads; ++j) {
      const int i = tid + j * kThreads;
      const int b = b0 + i / kTK, p = k0 + i % kTK;
      stage_a[j] = (b < B && p < P) ? to_float(a[static_cast<size_t>(b) * P + p]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kBLoads; ++j) {
      const int i = tid + j * kThreads;
      const int p = k0 + i / kTN, g = g0 + i % kTN;
      stage_b[j] = (p < P && g < G) ? to_float(w[static_cast<size_t>(p) * G + g]) : 0.f;
    }
    __syncthreads();  // the previous chunk is fully consumed
#pragma unroll
    for (int j = 0; j < kALoads; ++j) {
      const int i = tid + j * kThreads;
      sh_a[i % kTK][i / kTK] = stage_a[j];
    }
#pragma unroll
    for (int j = 0; j < kBLoads; ++j) {
      const int i = tid + j * kThreads;
      sh_b[i / kTN][i % kTN] = stage_b[j];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTK; ++k) {
      float av[kRM], bv[kRN];
#pragma unroll
      for (int i = 0; i < kRM; ++i) av[i] = sh_a[k][ty + i * kTY];
#pragma unroll
      for (int j = 0; j < kRN; ++j) bv[j] = sh_b[k][tx + j * kTX];
#pragma unroll
      for (int i = 0; i < kRM; ++i)
#pragma unroll
        for (int j = 0; j < kRN; ++j) acc[i][j] += av[i] * bv[j];
    }
  }

  float* o = out + static_cast<size_t>(s) * B * G;
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int b = b0 + ty + i * kTY;
    if (b >= B) continue;
#pragma unroll
    for (int j = 0; j < kRN; ++j) {
      const int g = g0 + tx + j * kTX;
      if (g < G) o[static_cast<size_t>(b) * G + g] = acc[i][j];
    }
  }
}

template <typename TX, typename TW>
cudaError_t launch(const void* xg, const void* packed, void* out, int N, int B, int P, int G,
                   cudaStream_t stream) {
  const dim3 grid((G + kTN - 1) / kTN, (B + kTM - 1) / kTM, N);
  const dim3 block(kTX, kTY);
  grouped_cs_kernel<TX, TW><<<grid, block, 0, stream>>>(
      static_cast<const TX*>(xg), static_cast<const TW*>(packed), static_cast<float*>(out), B,
      P, G);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// xg_bf16 / packed_bf16: 1 when that operand holds bf16, 0 when it holds f32.
extern "C" int grouped_cs_matmul_launch(const void* xg, int xg_bf16, const void* packed,
                                        int packed_bf16, void* out, int N, int B, int P, int G,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (xg_bf16 && packed_bf16)
    err = launch<__nv_bfloat16, __nv_bfloat16>(xg, packed, out, N, B, P, G, st);
  else if (xg_bf16)
    err = launch<__nv_bfloat16, float>(xg, packed, out, N, B, P, G, st);
  else if (packed_bf16)
    err = launch<float, __nv_bfloat16>(xg, packed, out, N, B, P, G, st);
  else
    err = launch<float, float>(xg, packed, out, N, B, P, G, st);
  return static_cast<int>(err);
}

extern "C" const char* grouped_cs_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
