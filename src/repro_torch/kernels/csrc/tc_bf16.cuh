// bf16 tensor-core building blocks for sm_90a, shared by packed_matmul.cu and
// grouped_cs_matmul.cu: 16-byte cp.async staging with zero-fill (and its
// plain-load twin, which topk_gather.cu stages with too), swizzled shared-memory tiles that ldmatrix reads without
// bank conflicts, the m16n8k16 mma.sync body over one K chunk, and the
// epilogue that writes a block's f32 tile.
//
// Every tile in shared memory is bf16, stored in 16-byte chunks. Chunk c of row r
// sits at chunk c ^ f(r), where f spreads 8 consecutive rows over the 8
// four-bank groups, so the 8 row addresses of an ldmatrix 8x8 matrix (8 rows,
// one chunk) hit 32 distinct banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

constexpr int kWarp = 32;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c of row r in a tile whose rows are kChunks
// chunks long (kChunks a power of two).
template <int kChunks>
__device__ __forceinline__ int swz(int r, int c) {
  static_assert(kChunks > 0 && (kChunks & (kChunks - 1)) == 0, "kChunks: a power of two");
  constexpr unsigned kPeriod = kChunks >= 8 ? 1 : 8 / kChunks;  // rows that share a 128-byte line
  constexpr unsigned kMod = kChunks >= 8 ? 8 : kChunks;
  const unsigned ur = r, uc = c;  // never negative: shifts and masks, not signed division
  return static_cast<int>((ur * kChunks + (uc ^ ((ur / kPeriod) % kMod))) * 16);
}

// 16 bytes from global to shared memory; with `valid` false, 16 zero bytes
// and no global read (cp.async's src-size 0), so ragged edges need no branch.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Stage the 16 bytes at src (the first `count` of kElems elements of size
// kSize are the operand's, the rest, or all when count <= 0, zeros) into
// shared memory at dst. kAsync: one 16-byte cp.async, which needs src 16-byte
// aligned and count >= kElems or <= 0 (the wrapper checks the alignment of
// every base and row stride, which gives both); otherwise plain loads, one
// element at a time, for any alignment.
template <bool kAsync, int kSize>
__device__ __forceinline__ void stage16(void* dst, const void* src, int count) {
  constexpr int kElems = 16 / kSize;
  if constexpr (kAsync) {
    cp_async_16(smem_u32(dst), src, count > 0);
  } else {
    uint4 v = make_uint4(0, 0, 0, 0);
    uint8_t* out = reinterpret_cast<uint8_t*>(&v);
    const uint8_t* in = static_cast<const uint8_t*>(src);
#pragma unroll
    for (int e = 0; e < kElems; ++e)
      if (e < count) {
        if constexpr (kSize == 4)
          *reinterpret_cast<uint32_t*>(out + 4 * e) = *reinterpret_cast<const uint32_t*>(in + 4 * e);
        else if constexpr (kSize == 2)
          *reinterpret_cast<uint16_t*>(out + 2 * e) = *reinterpret_cast<const uint16_t*>(in + 2 * e);
        else
          out[e] = in[e];
      }
    *static_cast<uint4*>(dst) = v;
  }
}

// One thread's share of the 16-byte pieces that stage a tile, the same in
// every chunk, worked out once, so that a chunk costs an add and a copy a
// piece. fill(i, src, dst, k, left) describes piece i: its global address at
// chunk 0 (left nullptr for a row past the B or G edge, which is zero-filled
// in every chunk), its byte offset in the stage (left negative for a piece
// that is never staged), its K index within a chunk, and the operand's
// elements from the piece to the end of its row at chunk 0. Pieces past the
// K edge are zero-filled too.
template <int kPieces, int kThreads>
struct Pieces {
  static constexpr int kIters = (kPieces + kThreads - 1) / kThreads;
  const uint8_t* src[kIters];
  int dst[kIters], k[kIters], left[kIters];

  template <class Fill>
  __device__ __forceinline__ explicit Pieces(Fill fill) {
#pragma unroll
    for (int j = 0; j < kIters; ++j) {
      const int i = static_cast<int>(threadIdx.x) + j * kThreads;
      src[j] = nullptr;
      dst[j] = -1;
      k[j] = left[j] = 0;
      if (kPieces % kThreads == 0 || i < kPieces) fill(i, src[j], dst[j], k[j], left[j]);
    }
  }

  // Stage the chunk whose K indices start at k0 (k_end: the operand's K
  // extent) into stage st. step: bytes of global memory per unit of K.
  // kKMajor: a piece's K index is its row, so its row's length is fixed;
  // otherwise its column, and the row left shrinks by k0. any: a valid
  // global address, passed (and not read) with the zero-fills.
  template <bool kAsync, int kSize, bool kKMajor>
  __device__ __forceinline__ void stage(uint8_t* st, int k0, int k_end, size_t step,
                                        const void* any) const {
#pragma unroll
    for (int j = 0; j < kIters; ++j) {
      if (dst[j] < 0) continue;
      const bool in = src[j] != nullptr && k0 + k[j] < k_end;
      stage16<kAsync, kSize>(st + dst[j], in ? src[j] + k0 * step : any,
                             in ? (kKMajor ? left[j] : left[j] - k0) : 0);
    }
  }
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A block's output tile (kBM x kBN), computed by kWM x kWN x kWK warps: warp
// (wm, wn, wk) owns rows [wm*WM, +WM) and columns [wn*WN, +WN) of the tile
// and the K steps wk, wk + kWK, ... of every chunk of kBK. With kWK > 1 the
// warps split K and their partial sums meet in the epilogue.
template <int kBM, int kBN, int kWM, int kWN, int kWK, int kBK = 64>
struct Tile {
  static constexpr int BM = kBM, BN = kBN, BK = kBK;
  static constexpr int WM = kBM / kWM, WN = kBN / kWN;  // one warp's rows, columns
  static constexpr int MT = WM / 16, NT = WN / 8;       // its m16 and n8 tiles
  static constexpr int kWarps = kWM * kWN * kWK;
  static constexpr int kThreads = kWarps * kWarp;
  static constexpr int kKChunks = kBK / 8;   // 16-byte chunks in a K row
  static constexpr int kNChunks = kBN / 8;   // 16-byte chunks in an N row
  static constexpr int kPad = 4;             // f32 per row of the epilogue's scratch
  static constexpr int kScratchBytes = kWK * kBM * (kBN + kPad) * 4;
  static_assert(kBM % (16 * kWM) == 0 && kBN % (16 * kWN) == 0, "warp tiles of m16 x n16");
  static_assert(kBK % (16 * kWK) == 0 && kBK / 16 / kWK <= 4,
                "K chunk: whole k16 steps per warp, at most 4 (their fragments stay in registers)");

  int wm, wn, wk, lane;
  float acc[MT][NT][4];

  __device__ __forceinline__ Tile() {
    const int warp = threadIdx.x / kWarp;
    lane = threadIdx.x % kWarp;
    wm = warp % kWM;
    wn = (warp / kWM) % kWN;
    wk = warp / (kWM * kWN);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }

  // One K chunk. a: the A tile [BM][BK], K contiguous. b: the B tile, either
  // [BN][BK] (K contiguous, kBKMajor false: plain ldmatrix gives the .col
  // fragment) or [BK][BN] (N contiguous, kBKMajor true: ldmatrix.trans).
  // Every fragment of the warp's K steps is loaded before the first mma, so
  // the warp waits for shared memory once a chunk, not once an mma.
  template <bool kBKMajor>
  __device__ __forceinline__ void mma_chunk(const void* a, const void* b) {
    constexpr int KS = BK / 16 / kWK;  // the warp's K steps
    const uint32_t a0 = smem_u32(a), b0 = smem_u32(b);
    uint32_t af[KS][MT][4], bf[KS][NT / 2][4];  // bf: b0, b1 of n8 tiles 2j, 2j+1
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int ks = kk * kWK + wk;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int row = wm * WM + i * 16 + lane % 16;
        ldmatrix_x4(af[kk][i], a0 + swz<kKChunks>(row, ks * 2 + lane / 16));
      }
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        if constexpr (kBKMajor) {
          const int k = ks * 16 + lane % 16;
          ldmatrix_x4_trans(bf[kk][j], b0 + swz<kNChunks>(k, (wn * WN + j * 16) / 8 + lane / 16));
        } else {
          const int n = wn * WN + j * 16 + lane % 8 + (lane / 16) * 8;
          ldmatrix_x4(bf[kk][j], b0 + swz<kKChunks>(n, ks * 2 + (lane / 8) % 2));
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int j = 0; j < NT / 2; ++j)
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_16816(acc[i][2 * j], af[kk][i], bf[kk][j][0], bf[kk][j][1]);
          mma_16816(acc[i][2 * j + 1], af[kk][i], bf[kk][j][2], bf[kk][j][3]);
        }
  }

  // Write the tile to out (row stride ld floats), rows < rows and columns <
  // cols only: each warp's fragments go through shared memory (the ring,
  // whose copies have all landed), where the kWK partial sums are added, and
  // leave in coalesced rows.
  __device__ __forceinline__ void store(void* scratch, float* out, size_t ld, int rows,
                                        int cols) {
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with the ring
    float* s = static_cast<float*>(scratch);
    constexpr int kLd = BN + kPad;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm * WM + i * 16 + lane / 4 + h * 8;
          const int c = wn * WN + j * 8 + (lane % 4) * 2;
          *reinterpret_cast<float2*>(&s[(wk * BM + r) * kLd + c]) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
    __syncthreads();
    for (int e = threadIdx.x; e < BM * BN; e += kThreads) {
      const int r = e / BN, c = e % BN;
      if (r >= rows || c >= cols) continue;
      float v = 0.f;
#pragma unroll
      for (int k = 0; k < kWK; ++k) v += s[(k * BM + r) * kLd + c];
      out[r * ld + c] = v;
    }
  }
};

// Set a kernel's dynamic shared memory limit where it needs more than the
// default 48 KB.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace tc
