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
// accumulated in f32. 2*N*B*P*G = 2*B*D_in*D_out/N flops: the paper's N-fold
// cut in multiply-adds.
//
// What bounds it: bytes. At smollm-360m's up projection over 128 tokens in
// bf16 (N=4, B=128, P=240, G=640) it moves ~2.79 MB, ~0.83 us at 3.35 TB/s,
// for 0.157 GFLOP (~0.16 us at the bf16 tensor-core rate).
//
// bf16 x bf16: a tensor-core body (tc_bf16.cuh). The first version staged
// every chunk through registers and synchronised twice before computing, so
// its time was a chain of global-load latencies, one per chunk. Here the xg
// tile [BM][64 partitions] (K contiguous, ldmatrix) and the packed tile
// [64 partitions][BN] (G contiguous, ldmatrix.trans) arrive through a ring
// of 6 stages of 16-byte cp.async copies: chunks c+1..c+5 are in flight
// while chunk c is multiplied with mma.sync m16n8k16 (f32 accumulators in
// registers until the epilogue), one __syncthreads a chunk. At P=240 that
// is all 4 chunks in flight from the start. Where each of a thread's copies
// goes is the same in every chunk and is worked out once. Shared tiles are
// XOR-swizzled, so ldmatrix has no bank conflicts. The ragged K edge (P=240
// is 3.75 chunks) and the ragged B and G edges are cp.async zero-fills, not
// branches in the main loop.
//
// Tiles, by B (a rule of the launcher, not a knob): B > 16, 32 x 32 outputs
// a block, 4 warps, 2 warp rows of 16 x 32 with each chunk's K split
// between two warps (320 blocks at the timed shape); B <= 16 (a decode
// batch), 16 x 16 outputs a block, its 4 warps splitting each chunk's K, so
// that the 16-row tile that wastes its empty rows still streams the weights
// from 160 blocks (N=4, G=640). Split sums meet in the epilogue.
//
// The 16-byte copies need every base address and row stride 16-byte
// aligned; the wrapper checks and passes `aligned`. Where it is 0 the same
// body stages with plain element loads.
//
// f32 x f32 and the mixed pairs keep the first version's CUDA-core body,
// unchanged, so their results stay exact f32: a shared-memory tiled product
// computed in the kernel's own body (no cuBLAS). A block owns a 32 x 64 tile
// of one slot's (B, G) output (blockIdx.z = s); per chunk of 16 partitions
// it stages the xg tile (transposed, padded against bank conflicts) and the
// packed tile in shared memory as f32, all of the chunk's global loads in
// flight at once; each of its 16 x 16 threads owns 2 x 4 outputs, rows
// ty + 16i and columns tx + 16j. Ragged B, P and G edges are staged as zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_bf16.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32 and mixed operand types: the CUDA-core body
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// bf16 x bf16: the tensor-core body
// ---------------------------------------------------------------------------

constexpr int kTcStages = 6;
using TileSmall = tc::Tile<16, 16, 1, 1, 4>;  // B <= 16
using TileLarge = tc::Tile<32, 32, 2, 1, 2>;

template <class T, bool kAsync>
__global__ void __launch_bounds__(T::kThreads)
grouped_tc_kernel(const __nv_bfloat16* __restrict__ xg, const __nv_bfloat16* __restrict__ packed,
                  float* __restrict__ out, int B, int P, int G) {
  constexpr int kABytes = T::BM * T::BK * 2;  // xg tile [BM][BK]
  constexpr int kStageBytes = kABytes + T::BK * T::BN * 2;  // + packed tile [BK][BN]
  static_assert(kTcStages >= 3, "a ring of at least 3 stages");
  extern __shared__ __align__(128) uint8_t smem[];

  const int s = blockIdx.z;
  const int b0 = blockIdx.y * T::BM;
  const int g0 = blockIdx.x * T::BN;
  const __nv_bfloat16* a = xg + static_cast<size_t>(s) * B * P;
  const __nv_bfloat16* w = packed + static_cast<size_t>(s) * P * G;
  const int chunks = (P + T::BK - 1) / T::BK;

  using bytes = const uint8_t*;
  const tc::Pieces<T::BM * T::kKChunks, T::kThreads> a_pieces(
      [&](int i, bytes& src, int& dst, int& k, int& left) {
        const int r = i / T::kKChunks, c = i % T::kKChunks;  // row b0 + r, partitions 8c..
        dst = tc::swz<T::kKChunks>(r, c);
        k = c * 8;
        left = P - c * 8;
        if (b0 + r < B) src = reinterpret_cast<bytes>(a + static_cast<size_t>(b0 + r) * P + c * 8);
      });
  const tc::Pieces<T::BK * T::kNChunks, T::kThreads> b_pieces(
      [&](int i, bytes& src, int& dst, int& k, int& left) {
        const int r = i / T::kNChunks, c = i % T::kNChunks;  // partition r, groups g0 + 8c..
        dst = kABytes + tc::swz<T::kNChunks>(r, c);
        k = r;
        left = G - (g0 + c * 8);
        if (left > 0) src = reinterpret_cast<bytes>(w + static_cast<size_t>(r) * G + g0 + c * 8);
      });
  auto load = [&](int chunk) {
    uint8_t* st = smem + (chunk % kTcStages) * kStageBytes;
    const int k0 = chunk * T::BK;
    a_pieces.template stage<kAsync, 2, false>(st, k0, P, 2, a);
    b_pieces.template stage<kAsync, 2, true>(st, k0, P, static_cast<size_t>(G) * 2, w);
  };

  T tile;
#pragma unroll
  for (int c = 0; c < kTcStages - 1; ++c) {
    if (c < chunks) load(c);
    tc::cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    tc::cp_async_wait<kTcStages - 2>();  // chunk c has landed
    __syncthreads();  // ... for every thread; and chunk c-1's slot is free
    if (c + kTcStages - 1 < chunks) load(c + kTcStages - 1);
    tc::cp_async_commit();
    const uint8_t* st = smem + (c % kTcStages) * kStageBytes;
    tile.template mma_chunk<true>(st, st + kABytes);
  }
  tile.store(smem, out + (static_cast<size_t>(s) * B + b0) * G + g0, G, B - b0, G - g0);
}

template <class T, bool kAsync>
cudaError_t launch_tc(const void* xg, const void* packed, void* out, int N, int B, int P, int G,
                      cudaStream_t stream) {
  constexpr int kRing = kTcStages * (T::BM * T::BK + T::BK * T::BN) * 2;
  constexpr int kSmem = kRing > T::kScratchBytes ? kRing : T::kScratchBytes;
  auto kernel = grouped_tc_kernel<T, kAsync>;
  cudaError_t err = tc::allow_smem(kernel, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((G + T::BN - 1) / T::BN, (B + T::BM - 1) / T::BM, N);
  kernel<<<grid, T::kThreads, kSmem, stream>>>(static_cast<const __nv_bfloat16*>(xg),
                                               static_cast<const __nv_bfloat16*>(packed),
                                               static_cast<float*>(out), B, P, G);
  return cudaGetLastError();
}

template <bool kAsync>
cudaError_t launch_bf16(const void* xg, const void* packed, void* out, int N, int B, int P, int G,
                        cudaStream_t stream) {
  if (B <= 16) return launch_tc<TileSmall, kAsync>(xg, packed, out, N, B, P, G, stream);
  return launch_tc<TileLarge, kAsync>(xg, packed, out, N, B, P, G, stream);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// xg_bf16 / packed_bf16: 1 when that operand holds bf16, 0 when it holds f32.
// aligned: 1 when both operands' base addresses and row strides are
// multiples of 16 bytes (read by the bf16 x bf16 body only).
extern "C" int grouped_cs_matmul_launch(const void* xg, int xg_bf16, const void* packed,
                                        int packed_bf16, int aligned, void* out, int N, int B,
                                        int P, int G, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (xg_bf16 && packed_bf16)
    err = aligned ? launch_bf16<true>(xg, packed, out, N, B, P, G, st)
                  : launch_bf16<false>(xg, packed, out, N, B, P, G, st);
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
