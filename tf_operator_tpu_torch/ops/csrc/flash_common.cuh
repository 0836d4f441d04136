// Tiles, shared-memory layout and warp-level helpers of the WMMA dQ kernel
// (flash_bwd.cu); the forward and dK/dV kernels use hopper.cuh instead.
//
// A thread block holds one 64-row tile of the Q rows it owns and streams
// the K/V side past in 64-row tiles. Each of its four warps owns 16 of the block's
// rows, so the score, softmax and gradient algebra of a row never leaves its
// warp: only the tile loads need the whole block to synchronise.
//
// The matrix products run on the tensor cores through WMMA fragments
// (bf16 x bf16 -> fp32, 16x16x16) loaded from shared memory; scores and
// probabilities pass through shared memory in fp32, where each lane owns
// two of a row's 64 columns. Rows are padded (+8 bf16, +4 fp32) so that
// fragment rows do not all start in the same bank.
#pragma once

#include "common.cuh"

#include <mma.h>

namespace flash {

using namespace nvcuda;

constexpr int kTile = 64;    // rows of every Q and K/V tile
constexpr int kWarps = 4;    // warp w owns rows [16w, 16w + 16) of the tile
constexpr int kThreads = 32 * kWarps;
constexpr int kLdS = kTile + 4;  // fp32 score tile row stride
constexpr int kLdP = kTile + 8;  // bf16 probability tile row stride
// Large-but-finite mask value, as the TPU kernels use: exp(x - x) on a
// fully-masked row must not produce inf - inf = nan.
constexpr float kMask = -1e30f;

template <int D>
struct Layout {
  static constexpr int ld = D + 8;    // bf16 operand tile row stride
  static constexpr int ldo = D + 4;   // fp32 accumulator tile row stride
  static constexpr int tile_bytes = kTile * ld * 2;
  static constexpr int score_bytes = kTile * kLdS * 4;
  static constexpr int prob_bytes = kTile * kLdP * 2;
  static constexpr int acc_bytes = kTile * ldo * 4;
  static constexpr int row_bytes = kTile * 4;
};

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBt;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// Copy the 64 rows of one head that start at `src` (BSHD: consecutive rows
// are `row_stride` elements apart) into shared memory, 16 bytes a thread;
// rows at or beyond `valid` are zero-filled (the ragged end of a sequence).
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src,
                                          long long row_stride, int valid) {
  constexpr int kVec = D / 8;
  for (int i = threadIdx.x; i < kTile * kVec; i += kThreads) {
    const int r = i / kVec;
    const int c = (i % kVec) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * Layout<D>::ld + c) = val;
  }
}

// C[16 x 64] = A[16 x D] * B[64 x D]^T for one warp: A and B are bf16 tiles
// in shared memory (row stride D + 8), C is fp32 (row stride kLdS).
template <int D>
__device__ __forceinline__ void warp_abt(const bf16* A, const bf16* B, float* C) {
  constexpr int ld = Layout<D>::ld;
  FragC acc[kTile / 16];
#pragma unroll
  for (int n = 0; n < kTile / 16; ++n) wmma::fill_fragment(acc[n], 0.0f);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    FragA a;
    wmma::load_matrix_sync(a, A + kk * 16, ld);
#pragma unroll
    for (int n = 0; n < kTile / 16; ++n) {
      FragBt b;
      wmma::load_matrix_sync(b, B + n * 16 * ld + kk * 16, ld);
      wmma::mma_sync(acc[n], a, b, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < kTile / 16; ++n)
    wmma::store_matrix_sync(C + n * 16, acc[n], kLdS, wmma::mem_row_major);
}

// acc[D/16] (16 x D) += P[16 x 64] * B[64 x D] for one warp: P is a bf16
// tile of row stride kLdP, B a bf16 tile of row stride D + 8.
template <int D>
__device__ __forceinline__ void warp_pb(FragC* acc, const bf16* P, const bf16* B) {
  constexpr int ld = Layout<D>::ld;
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    FragA a;
    wmma::load_matrix_sync(a, P + kk * 16, kLdP);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      FragB b;
      wmma::load_matrix_sync(b, B + kk * 16 * ld + n * 16, ld);
      wmma::mma_sync(acc[n], a, b, acc[n]);
    }
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Write this warp's 16 rows of a fp32 tile (row stride D + 4), times
// `scale`, as bf16 rows of a BSHD tensor; rows at or beyond `valid` are
// padding and are not written.
template <int D>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, long long row_stride,
                                           const float* tile, int r0, int valid,
                                           float scale) {
  const int lane = threadIdx.x % 32;
  for (int r = 0; r < 16 && r0 + r < valid; ++r) {
    const float* src = tile + (r0 + r) * Layout<D>::ldo;
    bf16* out = dst + (r0 + r) * row_stride;
    for (int c = lane; c < D; c += 32) out[c] = __float2bfloat16(src[c] * scale);
  }
}

// Raise the kernel's dynamic shared-memory limit (needed above 48 KB).
template <typename K>
__host__ inline cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                              cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace flash
