// Matmul against complementary-sparse packed weights, decompressed on the
// fly, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel kernels/packed_matmul.py:_packed_matmul_kernel
// of the JAX package (launched by packed_matmul). It computes
//
//   out[b, g*N + s] = sum_p packed[g, p, s] * x[b, p*N + route[g / R, p, s]]
//
// that is x @ decompress(packed, route) with no dense weight in device
// memory: the paper's Multiply-Route-Sum, 2*B*P*G*N = 2*B*D_in*D_out/N flops.
// x (B, P*N) f32 or bf16; packed (G, P, N) f32 or bf16, the layers' own
// layout; route (G/R, P, N) int8, read in place (never transposed or
// repeated out to G); out (B, G*N) f32. A route entry outside [0, N)
// selects no input and adds nothing, as in the TPU kernel.
//
// What bounds it: bytes. smollm-360m's up projection over 128 tokens in bf16
// (B=128, P=240, G=640, N=4, R=G) moves ~2.79 MB, ~0.83 us at 3.35 TB/s.
//
// bf16 x bf16: a tensor-core body (tc_bf16.cuh), built as the TPU kernel
// builds its MXU operand in VMEM. The first version computed the
// Multiply-Route-Sum on the f32 CUDA cores after staging every chunk
// through registers and two __syncthreads, so its time was a chain of
// global-load latencies, one per chunk. Here a chunk is 128 inputs (128/N
// partitions), so that a chunk's fixed costs (a wait, a barrier) buy twice
// the work of a 64-input one. A ring of 4 stages of 16-byte cp.async
// copies brings, per chunk, the x tile [BM][128], the raw packed tile
// [BN/N groups][128] (rows of 256 B, 8 of them at N=4, BN=32) and the route
// rows those groups read (one row at R=G, one a group at R=1). Each chunk is
// expanded, from shared memory, into the dense bf16 tile W[p*N+i][g*N+s] =
// packed[g,p,s] * (route[g/R,p,s] == i), stored [g*N+s][p*N+i] (K
// contiguous) so that ldmatrix gives the .col operand without a transpose,
// and multiplied with mma.sync m16n8k16 into f32 registers. The expansion
// of chunk c+1 runs while chunk c is multiplied (two expanded tiles) and
// chunks c+2 and c+3 are in flight: one __syncthreads a chunk. Where each of a thread's copies and
// expanded weights goes is the same in every chunk and is worked out once,
// outside the chunk loop. Shared tiles are XOR-swizzled, so ldmatrix has no
// bank conflicts; ragged B, K and G edges are cp.async zero-fills, not
// branches.
//
// The expansion does N times the multiply-adds of the Multiply-Route-Sum:
// 2*B*D_in*D_out = 0.63 GFLOP at the timed shape, ~0.64 us at the dense bf16
// tensor-core peak (989 TFLOP/s), still below the byte bound.
//
// Tiles, by B (a rule of the launcher, not a knob): B > 16, 32 x 32 outputs
// a block, 4 warps, 2 warp rows of 16 x 32 with each chunk's K split
// between two warps (320 blocks at the timed shape); B <= 16 (a decode
// batch), 16 x 16 outputs a block, its 4 warps splitting each chunk's K, so
// that the 16-row tile that wastes its empty rows still streams the 1.23 MB
// of packed weights from 160 blocks (G*N = 2560). Split sums meet in the
// epilogue.
//
// The 16-byte copies need every base address and row stride 16-byte aligned
// (rows of P*N bf16 and of P*N int8); the wrapper checks and passes
// `aligned`. Where it is 0 the same body stages with plain element loads.
//
// f32 x f32 and the mixed pairs keep the first version's CUDA-core body,
// unchanged, so their results stay exact f32: each thread computes its
// outputs directly. A block owns 16 rows x 32 groups (each group's N
// slots). Per chunk of 64 inputs it stages the rows' inputs, and the groups'
// weights and routes transposed (padded against bank conflicts), in shared
// memory as f32/int, all of the chunk's global loads in flight at once;
// thread (lane, warp) owns group lane and rows warp and warp+8, with N f32
// accumulators each. Each weight multiplies the staged input its route
// picks. Ragged B, P and G edges are staged as zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_bf16.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32 and mixed operand types: the CUDA-core body
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// bf16 x bf16: the tensor-core body
// ---------------------------------------------------------------------------

constexpr int kTcStages = 4;
using TileSmall = tc::Tile<16, 16, 1, 1, 4, 128>;  // B <= 16
using TileLarge = tc::Tile<32, 32, 2, 1, 2, 128>;

// Store the N expanded weights of one packed entry, w where the route picks
// input i and 0 elsewhere, at W[n][k .. k+N) of the K-contiguous
// [BN][8 * kChunks] tile: w shifted into 16-bit lane `route` of the N
// lanes, or nothing where the route lies outside [0, N).
template <int N, int kChunks>
__device__ __forceinline__ void put_expanded(uint8_t* wt, int n, int k, uint16_t w, int route) {
  const bool hit = static_cast<unsigned>(route) < static_cast<unsigned>(N);
  const unsigned uk = k;
  uint8_t* at = wt + tc::swz<kChunks>(n, uk / 8) + (uk % 8) * 2;
  if constexpr (N == 1) {
    *reinterpret_cast<uint16_t*>(at) = hit ? w : 0;
  } else if constexpr (N == 2) {
    *reinterpret_cast<uint32_t*>(at) = hit ? uint32_t{w} << (16 * route) : 0u;
  } else if constexpr (N == 4) {
    *reinterpret_cast<uint64_t*>(at) = hit ? uint64_t{w} << (16 * route) : 0ull;
  } else {  // whole 16-byte chunks, 8 lanes each; w lies in 32-bit word route / 2
    const uint32_t word = hit ? uint32_t{w} << (16 * (route & 1)) : 0u;
#pragma unroll
    for (int q = 0; q < N / 8; ++q) {
      const int at_word = (route >> 1) - 4 * q;
      *reinterpret_cast<uint4*>(wt + tc::swz<kChunks>(n, k / 8 + q)) =
          make_uint4(at_word == 0 ? word : 0u, at_word == 1 ? word : 0u,
                     at_word == 2 ? word : 0u, at_word == 3 ? word : 0u);
    }
  }
}

template <class T, int N, bool kAsync>
__global__ void __launch_bounds__(T::kThreads)
packed_tc_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ packed,
                 const int8_t* __restrict__ route, float* __restrict__ out, int B, int P, int G,
                 int R) {
  constexpr int BK = T::BK;
  constexpr int kGroups = T::BN / N;  // groups a tile
  static_assert(T::BN % N == 0 && BK % N == 0 && BK % 16 == 0, "whole groups and partitions");
  static_assert(kTcStages >= 3, "a ring of at least 3 stages");
  constexpr int kXBytes = T::BM * BK * 2;   // x tile [BM][BK], swizzled
  constexpr int kPBytes = kGroups * BK * 2;  // packed tile [group][BK]
  constexpr int kRBytes = kGroups * BK;      // route rows [row][BK]
  constexpr int kStageBytes = kXBytes + kPBytes + kRBytes;
  constexpr int kWBytes = T::BN * BK * 2;    // expanded tile [BN][BK], swizzled
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* wexp = smem + kTcStages * kStageBytes;

  const int b0 = blockIdx.y * T::BM;
  const int g0 = blockIdx.x * kGroups;
  const int d_in = P * N;
  const int chunks = (d_in + BK - 1) / BK;
  const int route0 = g0 / R;  // the first route row the tile reads
  const int route_rows = (min(g0 + kGroups, G) - 1) / R - route0 + 1;

  using bytes = const uint8_t*;
  const tc::Pieces<T::BM * (BK / 8), T::kThreads> x_pieces(
      [&](int i, bytes& src, int& dst, int& k, int& left) {
        const int r = i / (BK / 8), c = i % (BK / 8);  // row b0 + r, inputs 8c..
        dst = tc::swz<BK / 8>(r, c);
        k = c * 8;
        left = d_in - c * 8;
        if (b0 + r < B) src = reinterpret_cast<bytes>(x + static_cast<size_t>(b0 + r) * d_in + c * 8);
      });
  const tc::Pieces<kGroups * (BK / 8), T::kThreads> p_pieces(
      [&](int i, bytes& src, int& dst, int& k, int& left) {
        const int r = i / (BK / 8), c = i % (BK / 8);  // group g0 + r, inputs 8c..
        dst = kXBytes + i * 16;
        k = c * 8;
        left = d_in - c * 8;
        if (g0 + r < G)
          src = reinterpret_cast<bytes>(packed + static_cast<size_t>(g0 + r) * d_in + c * 8);
      });
  const tc::Pieces<kGroups * (BK / 16), T::kThreads> r_pieces(
      [&](int i, bytes& src, int& dst, int& k, int& left) {
        const int r = i / (BK / 16), c = i % (BK / 16);  // route row route0 + r, inputs 16c..
        dst = kXBytes + kPBytes + i * 16;
        k = c * 16;
        left = d_in - c * 16;
        if (r >= route_rows) dst = -1;  // a row no group of the tile reads
        else src = reinterpret_cast<bytes>(route + static_cast<size_t>(route0 + r) * d_in + c * 16);
      });
  auto load = [&](int chunk) {
    uint8_t* st = smem + (chunk % kTcStages) * kStageBytes;
    const int k0 = chunk * BK;
    x_pieces.template stage<kAsync, 2, false>(st, k0, d_in, 2, x);
    p_pieces.template stage<kAsync, 2, false>(st, k0, d_in, 2, packed);
    r_pieces.template stage<kAsync, 1, false>(st, k0, d_in, 1, route);
  };

  // Thread t expands the packed entries t, t + kThreads, ... of each chunk's
  // [group][BK] tile. Where each entry's route byte lies and where its N
  // weights go are the same in every chunk, so they are found once.
  constexpr int kEntries = kGroups * BK;
  constexpr int kExpand = (kEntries + T::kThreads - 1) / T::kThreads;
  int ex_route[kExpand], ex_n[kExpand], ex_k[kExpand];
#pragma unroll
  for (int j = 0; j < kExpand; ++j) {
    const int e = static_cast<int>(threadIdx.x) + j * T::kThreads;
    const int gl = e / BK, k = e % BK;  // k = p_local * N + s
    ex_route[j] = (min(g0 + gl, G - 1) / R - route0) * BK + k;
    ex_n[j] = gl * N + k % N;
    ex_k[j] = k - k % N;
  }

  // All of a thread's loads come before its first store, so it waits for
  // shared memory once a chunk.
  auto expand = [&](int chunk) {
    const uint8_t* st = smem + (chunk % kTcStages) * kStageBytes;
    const uint16_t* pk = reinterpret_cast<const uint16_t*>(st + kXBytes);
    const int8_t* rt = reinterpret_cast<const int8_t*>(st + kXBytes + kPBytes);
    uint8_t* wt = wexp + (chunk % 2) * kWBytes;
    uint16_t w[kExpand];
    int r[kExpand];
#pragma unroll
    for (int j = 0; j < kExpand; ++j) {
      if (kEntries % T::kThreads == 0 || static_cast<int>(threadIdx.x) + j * T::kThreads < kEntries) {
        w[j] = pk[threadIdx.x + j * T::kThreads];
        r[j] = rt[ex_route[j]];
      }
    }
#pragma unroll
    for (int j = 0; j < kExpand; ++j)
      if (kEntries % T::kThreads == 0 || static_cast<int>(threadIdx.x) + j * T::kThreads < kEntries)
        put_expanded<N, BK / 8>(wt, ex_n[j], ex_k[j], w[j], r[j]);
  };

  T tile;
#pragma unroll
  for (int c = 0; c < kTcStages - 1; ++c) {
    if (c < chunks) load(c);
    tc::cp_async_commit();
  }
  tc::cp_async_wait<kTcStages - 2>();  // chunk 0 has landed
  __syncthreads();
  expand(0);
  for (int c = 0; c < chunks; ++c) {
    tc::cp_async_wait<kTcStages - 3>();  // chunk c+1 has landed
    // ... for every thread; chunk c is expanded; chunk c-1 is multiplied,
    // so its slot and its expanded tile are free
    __syncthreads();
    if (c + kTcStages - 1 < chunks) load(c + kTcStages - 1);
    tc::cp_async_commit();
    if (c + 1 < chunks) expand(c + 1);
    tile.template mma_chunk<false>(smem + (c % kTcStages) * kStageBytes,
                                   wexp + (c % 2) * kWBytes);
  }
  const int col0 = blockIdx.x * T::BN;
  tile.store(smem, out + static_cast<size_t>(b0) * G * N + col0, static_cast<size_t>(G) * N,
             B - b0, G * N - col0);
}

template <class T, int N, bool kAsync>
cudaError_t launch_tc(const void* x, const void* packed, const void* route, void* out, int B,
                      int P, int G, int R, cudaStream_t stream) {
  constexpr int kGroups = T::BN / N;
  constexpr int kRing = kTcStages * (T::BM * T::BK * 2 + kGroups * T::BK * 3) +
                        2 * T::BN * T::BK * 2;
  constexpr int kSmem = kRing > T::kScratchBytes ? kRing : T::kScratchBytes;
  auto kernel = packed_tc_kernel<T, N, kAsync>;
  cudaError_t err = tc::allow_smem(kernel, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((G * N + T::BN - 1) / T::BN, (B + T::BM - 1) / T::BM);
  kernel<<<grid, T::kThreads, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(packed),
      static_cast<const int8_t*>(route), static_cast<float*>(out), B, P, G, R);
  return cudaGetLastError();
}

template <int N, bool kAsync>
cudaError_t launch_bf16(const void* x, const void* packed, const void* route, void* out, int B,
                        int P, int G, int R, cudaStream_t stream) {
  if (B <= 16) return launch_tc<TileSmall, N, kAsync>(x, packed, route, out, B, P, G, R, stream);
  return launch_tc<TileLarge, N, kAsync>(x, packed, route, out, B, P, G, R, stream);
}

template <bool kAsync>
cudaError_t launch_bf16_n(const void* x, const void* packed, const void* route, void* out, int B,
                          int P, int G, int N, int R, cudaStream_t stream) {
  switch (N) {
    case 1: return launch_bf16<1, kAsync>(x, packed, route, out, B, P, G, R, stream);
    case 2: return launch_bf16<2, kAsync>(x, packed, route, out, B, P, G, R, stream);
    case 4: return launch_bf16<4, kAsync>(x, packed, route, out, B, P, G, R, stream);
    case 8: return launch_bf16<8, kAsync>(x, packed, route, out, B, P, G, R, stream);
    case 16: return launch_bf16<16, kAsync>(x, packed, route, out, B, P, G, R, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// x_bf16 / packed_bf16: 1 when that operand holds bf16, 0 when it holds f32.
// aligned: 1 when every operand's base address and row stride are multiples
// of 16 bytes (read by the bf16 x bf16 body only).
extern "C" int packed_matmul_launch(const void* x, int x_bf16, const void* packed,
                                    int packed_bf16, const void* route, int aligned, void* out,
                                    int B, int P, int G, int N, int R, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_bf16 && packed_bf16)
    err = aligned ? launch_bf16_n<true>(x, packed, route, out, B, P, G, N, R, st)
                  : launch_bf16_n<false>(x, packed, route, out, B, P, G, N, R, st);
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
