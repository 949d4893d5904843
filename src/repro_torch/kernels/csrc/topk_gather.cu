// Sparse-sparse complementary-sparse contraction for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel kernels/topk_gather.py:_topk_gather_kernel
// of the JAX package (launched by topk_gather_matmul). It computes, for
// every batch row b and output (g, s):
//
//   out[b, g*N + s] = sum_k vals[b,k] * packed_p[p_idx[b,k], g, s]
//                               * (route[g / R, p_idx[b,k], s] == s_off[b,k])
//
// vals (B,K) f32 or bf16; p_idx, s_off (B,K) int32 or int64 (both the same);
// packed_p (P,G,N) f32 or bf16, partition-major; route (G/R,P,N) int8, read in
// place (the route shared by R groups is never repeated out to G); out
// (B, G*N) f32 or bf16, accumulated in f32 and rounded once. s_off is compared
// as int8, as the TPU kernel compares it with the route; an entry whose
// partition lies outside [0, P) adds nothing.
//
// What bounds it: bytes. Every non-zero reads one partition row of G*N
// packed weights, so the card must move min(P, distinct partitions) rows of
// G*N weights, while the arithmetic is 2*B*K*G flops. At the decode shape of
// smollm-360m (B=4, K=320, P=640, G=240, N=4, R=G, bf16) that is ~1.1 MB,
// 0.33 us at 3.35 TB/s, against ~0.6 MFLOP.
//
// What held the first version back (one block per (32 groups, row), 8 warps
// each walking K/8 entries): a latency chain on a quarter of the card. Its
// grid was 8 x 4 = 32 blocks on 132 SMs; each warp's 40 entries were each a
// chain of shared index, address, N scalar 2-byte weight loads and N route
// loads, at most 4 unrolled, every 256-byte strip a cold miss; and every row's
// blocks fetched the same strips again. Cold read 1.4x warm: latency, not
// bytes.
//
// Design:
// - Grid (strips * S, B), one block a (strip, row, K slice), in clusters of S
//   blocks along the K slices. A strip is `lanes` 16-byte vectors of a
//   partition row (lanes = 32, 512 B, 64 groups at N=4 in bf16, where the row
//   is that long; the next power of two above the row otherwise). The S
//   blocks of a cluster split the row's K entries into S slices of ceil(K/S).
//   S and lanes are the launcher rule of topk_gather.py:launch_rule: the
//   smallest S <= 8 that gives the grid 128 blocks (one a SM), and no more
//   blocks than entries. Main shape: 4 strips (the last 24 of 32 vectors wide,
//   a zero-filled edge) x 4 rows x S=8 = 128 blocks of 40 entries. Timed
//   against S = 2 and 4 and strips of 128 and 256 B, this was the fastest or
//   level: a block's time grows with its entries more than the cluster
//   barrier costs, and past about 264 blocks (two of these a SM) a second
//   wave costs more than either.
// - A block serves one batch row, not all B: the rows' supports overlap only
//   in part, sharing a strip across rows would need their partitions sorted
//   and matched, and a second fetch of a strip by another row's block is an
//   L2 hit; one row a block gives B times the blocks to hide the latency.
// - Stages, in one chunk where the slice fits (up to 24 KB of strips: 48
//   entries at 512 B): 1. the slice's values and partitions into shared
//   memory (one load each, int32 or int64, f32 or bf16); 2. every entry's
//   strip into shared memory at once, one 16-byte cp.async per (entry,
//   vector), 5 a thread at the main shape, with the ragged G edge and
//   partitions outside [0, P) zero-filled; 3. while they fly, each entry's N
//   route bytes (R = G: the one (P, N) table) become an N-bit match mask in
//   shared memory; 4. one wait, then each warp takes every 8th entry and
//   each lane accumulates its 16 B (2 groups at N=4 in bf16) in f32 from
//   shared memory. With R < G the route of a group is P*N bytes from the next
//   one's, so each lane reads its elements' route bytes with plain loads in
//   step 4 (correct, not tuned).
// - Operands a 16-byte copy cannot take (a packed row G*N*size or a base not a
//   multiple of 16 bytes) stage with plain loads into the same layout, behind
//   the `async` flag of topk_gather.py:async_staging.
// - Sums: lanes of a warp that hold one vector (lanes < 32) by a butterfly,
//   the 8 warps in order through shared memory; then each rank owns 1/S of
//   the strip, every block stores its partial of each element into the
//   owner's shared memory (distributed shared memory, slot by sender rank),
//   one cluster.sync(), and each owner adds the S partials in rank order and
//   writes the output. No atomics and one launch: the order is fixed, so two
//   launches on the same operands give bit-identical outputs. Pushing the
//   partials, not reading them, needs one cluster barrier and no remote
//   load: after it no block touches another's shared memory, so any block
//   may leave.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_bf16.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStripBytes = 24 * 1024;  // a chunk's strips in shared memory
constexpr int kMaxEntries = 256;        // a chunk's entries, at most
constexpr int kMaxCluster = 8;          // the portable cluster size
constexpr unsigned kFull = 0xffffffffu;

// flags
constexpr int kValsBf16 = 1, kIdx64 = 2, kOutBf16 = 4, kAsync = 8;

struct Args {
  const void* vals;
  const void* p_idx;
  const void* s_off;
  const void* packed;
  const int8_t* route;
  void* out;
  int K, P, G, R, lanes, flags;
};

// Element h of a 32-bit word that holds 4 / sizeof(T) elements, as float.
template <typename T>
__device__ __forceinline__ float word_elem(uint32_t w, int h) {
  if constexpr (sizeof(T) == 4) return __uint_as_float(w);
  else return __uint_as_float(h ? (w & 0xffff0000u) : (w << 16));
}

__device__ __forceinline__ long long load_index(const void* p, size_t at, bool idx64) {
  return idx64 ? static_cast<const long long*>(p)[at] : static_cast<const int*>(p)[at];
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads) topk_gather_kernel(const Args a) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));  // elements a 16-byte vector
  constexpr int kPerWord = 4 / static_cast<int>(sizeof(T));
  __shared__ __align__(16) uint8_t sh_strip[kStripBytes];
  __shared__ float sh_val[kMaxEntries];
  __shared__ int sh_p[kMaxEntries];     // partition, -1 outside [0, P)
  __shared__ int sh_key[kMaxEntries];   // R = G: match mask over s; else s_off as int8
  __shared__ float sh_warp[kWarps][32 * V];
  __shared__ float sh_inbox[32 * V + kMaxCluster];  // [rank][share], the S ranks' partials

  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y;
  const int lanes = a.lanes;
  const int row = a.G * N;                         // elements of a partition row
  const int e0 = (blockIdx.x / S) * lanes * V;     // the strip's first element
  const int per = (a.K + S - 1) / S;
  const int k_begin = min(a.K, rank * per), k_end = min(a.K, k_begin + per);
  const int cap = min(kMaxEntries, kStripBytes / (lanes * 16));
  const bool shared_route = a.R == a.G;
  const bool async = a.flags & kAsync, idx64 = a.flags & kIdx64;
  const T* packed = static_cast<const T*>(a.packed);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int shift = __ffs(lanes) - 1;  // lanes is a power of two
  const int vec = lane & (lanes - 1);  // the lane's vector of the strip
  const int sweep = 32 >> shift;       // entries a warp takes at once
  const size_t base = static_cast<size_t>(b) * a.K;

  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.f;

  for (int c0 = k_begin; c0 < k_end; c0 += cap) {
    const int n = min(cap, k_end - c0);
    // 1. the chunk's values and partitions
    for (int i = tid; i < n; i += kThreads) {
      const size_t at = base + c0 + i;
      sh_val[i] = a.flags & kValsBf16
                      ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.vals)[at])
                      : static_cast<const float*>(a.vals)[at];
      const long long p = load_index(a.p_idx, at, idx64);
      sh_p[i] = p >= 0 && p < a.P ? static_cast<int>(p) : -1;
    }
    __syncthreads();
    // 2. every entry's strip at once
    for (int j = tid; j < n * lanes; j += kThreads) {
      const int i = j >> shift, e = e0 + (j & (lanes - 1)) * V;
      const int p = sh_p[i];
      const int count = p < 0 ? 0 : min(V, row - e);
      const T* src = packed + (count > 0 ? static_cast<size_t>(p) * row + e : 0);
      if (async)
        tc::stage16<true, sizeof(T)>(sh_strip + j * 16, src, count);
      else
        tc::stage16<false, sizeof(T)>(sh_strip + j * 16, src, count);
    }
    tc::cp_async_commit();
    // 3. meanwhile, each entry's route key
    for (int i = tid; i < n; i += kThreads) {
      const int p = sh_p[i];
      const int8_t so = static_cast<int8_t>(load_index(a.s_off, base + c0 + i, idx64));
      int key = so;
      if (shared_route) {
        key = 0;
        if (p >= 0) {
          const int8_t* r = a.route + static_cast<size_t>(p) * N;
#pragma unroll
          for (int s = 0; s < N; ++s) key |= (r[s] == so) << s;
        }
      }
      sh_key[i] = key;
    }
    tc::cp_async_wait<0>();
    __syncthreads();
    // 4. accumulate from shared memory: warp w takes entries w, w + 8, ...
#pragma unroll 4
    for (int i = warp * sweep + (lane >> shift); i < n; i += kWarps * sweep) {
      const float v = sh_val[i];
      const int key = sh_key[i];
      const uint4 w4 = *reinterpret_cast<const uint4*>(sh_strip + (i * lanes + vec) * 16);
      const uint32_t w[4] = {w4.x, w4.y, w4.z, w4.w};
      const int p = sh_p[i];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int e = e0 + vec * V + j;
        const int s = e % N;
        bool hit;
        if (shared_route) {
          hit = (key >> s) & 1;
        } else {
          hit = p >= 0 && e < row &&
                a.route[(static_cast<size_t>(e / N / a.R) * a.P + p) * N + s] == key;
        }
        acc[j] = fmaf(hit ? v : 0.f, word_elem<T>(w[j / kPerWord], j % kPerWord), acc[j]);
      }
    }
    __syncthreads();  // the chunk is consumed before the next one is staged
  }

  // the lanes that hold one vector, then the warps in order
#pragma unroll
  for (int j = 0; j < V; ++j)
    for (int off = lanes; off < 32; off *= 2) acc[j] += __shfl_xor_sync(kFull, acc[j], off);
  if (lane < lanes) {
#pragma unroll
    for (int j = 0; j < V; ++j) sh_warp[warp][vec * V + j] = acc[j];
  }
  __syncthreads();
  // element e of the strip is added up by rank e / share: each block sends
  // its partial of e into that rank's inbox, slot [its own rank][e % share]
  const int E = lanes * V;  // elements of the strip
  const int share = (E + S - 1) / S;
  for (int e = tid; e < E; e += kThreads) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += sh_warp[w][e];
    const int owner = e / share;
    cluster.map_shared_rank(sh_inbox, owner)[rank * share + e - owner * share] = sum;
  }
  cluster.sync();  // every partial has arrived; no block reads another's memory after this
  for (int t = tid; t < share; t += kThreads) {
    const int e = rank * share + t;
    if (e >= E || e0 + e >= row) break;
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < S) sum += sh_inbox[r * share + t];
    const size_t at = static_cast<size_t>(b) * row + e0 + e;
    if (a.flags & kOutBf16)
      static_cast<__nv_bfloat16*>(a.out)[at] = __float2bfloat16_rn(sum);
    else
      static_cast<float*>(a.out)[at] = sum;
  }
}

template <typename T, int N>
cudaError_t launch(const Args& a, int B, int cluster, cudaStream_t stream) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const int row_vecs = (a.G * N + V - 1) / V;
  const int strips = (row_vecs + a.lanes - 1) / a.lanes;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(strips * cluster, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, topk_gather_kernel<T, N>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
cudaError_t launch_n(const Args& a, int B, int N, int cluster, cudaStream_t stream) {
  switch (N) {
    case 1: return launch<T, 1>(a, B, cluster, stream);
    case 2: return launch<T, 2>(a, B, cluster, stream);
    case 4: return launch<T, 4>(a, B, cluster, stream);
    case 8: return launch<T, 8>(a, B, cluster, stream);
    case 16: return launch<T, 16>(a, B, cluster, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches on `stream` and returns the launch's error (0 on success).
// Flags: vals_bf16 (vals bf16, else f32), idx64 (p_idx and s_off int64, else
// int32), packed_bf16, out_bf16, async (16-byte cp.async staging; else plain
// loads). cluster in {1, 2, 4, 8} and lanes a power of two in [1, 32]: the
// launcher rule of topk_gather.py:launch_rule.
extern "C" int topk_gather_launch(const void* vals, int vals_bf16, const void* p_idx,
                                  const void* s_off, int idx64, const void* packed,
                                  int packed_bf16, const void* route, void* out, int out_bf16,
                                  int B, int K, int P, int G, int N, int R, int cluster,
                                  int lanes, int async, void* stream) {
  if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) || lanes < 1 ||
      lanes > 32 || (lanes & (lanes - 1)) || K < 1 || B < 1 || R < 1 || G % R)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{vals, p_idx, s_off, packed, static_cast<const int8_t*>(route), out, K, P, G, R,
               lanes,
               (vals_bf16 ? kValsBf16 : 0) | (idx64 ? kIdx64 : 0) | (out_bf16 ? kOutBf16 : 0) |
                   (async ? kAsync : 0)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = packed_bf16 ? launch_n<__nv_bfloat16>(a, B, N, cluster, st)
                                      : launch_n<float>(a, B, N, cluster, st);
  return static_cast<int>(err);
}

extern "C" const char* topk_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
