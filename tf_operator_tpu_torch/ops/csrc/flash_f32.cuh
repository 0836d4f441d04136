// Building blocks of the fp32 flash kernels that run on the CUDA cores:
// flash_dq_f32.cu and flash_dkv_f32.cu at width 256 (the forward, and dQ
// and dK/dV at 64 and 128, run 3xTF32 on the tensor cores: tf32x3.cuh).
// Products of fp32 tiles in shared memory by FMAs, every sum in fp32.
//
// Why these stay on FMAs: at 256 a block's shared memory cannot hold the
// hi and lo parts of the 64 rows a warpgroup's wgmma needs (Q and dO for
// dQ, K and V for dK/dV: 256 KB against 227) beside any tile they meet;
// streaming the head dim in chunks is a redesign of its own (ROADMAP.md,
// Queue 2).
//
// Layout. Every tile is row-major, [rows][kD + 4] floats: the 4 floats of
// padding keep each row 16-byte aligned and put consecutive rows 4 banks
// apart, so that 16 threads reading one float4 each from 16 rows hit every
// bank once per 8 rows. A block has 256 threads, seen as 16 x 16: ty =
// threadIdx.x / 16 owns the rows 4ty .. 4ty + 3 of the block's 64-row tile
// and tx = threadIdx.x % 16 a set of columns.
//
// Two products cover the kernels' products:
// - dot_abt: C = A B^T with A [64][kD] and B [16 kJ][kD] both row-major
//   (S = Q K^T, dP = dO V^T, and in dK/dV their transposes K Q^T and
//   V dO^T): thread (ty, tx) sums the 4 x kJ outputs (4ty + i, tx + 16j)
//   over the true head dim, reading float4s along it;
// - dot_ab: C += A B with A^T [kK][64] (a tile the kernel wrote itself, P
//   or dS, in the orientation the product wants) and B [kK][kD] row-major
//   (dQ += dS K, dV += P^T dO, dK += dS^T Q): thread (ty, tx)
//   owns rows 4ty .. 4ty + 3 and the float4 column chunks 4tx + 64jj; a
//   chunk at or past the true head dim is skipped.
// Head dims. The kD 256 instances serve every head dim D that is a
// multiple of 8 from 136 to 256: the loads read D columns of a row, the
// products run over D, and the columns past D are neither read nor
// written.
#pragma once

#include "common.cuh"

namespace f32 {

constexpr int kThreads = 256;
constexpr int kRows = 64;        // rows of a block's own tile: 4 a thread x 16
constexpr int kTStride = 68;     // row stride of a written [kK][64] P or dS tile
constexpr float kLog2e = 1.4426950408889634f;

// Row stride, in floats, of a [rows][kD] tile.
template <int kD>
__host__ __device__ constexpr int stride() {
  return kD + 4;
}

// Rows r0 .. r0 + kR - 1 of head h, batch b of a contiguous fp32 BSHD tensor
// [B, S, H, D] into tile[kR][kStride], D columns; rows at S and past it are
// zeros (a zero Q row gives finite scores, a zero V row adds nothing).
template <int kR, int kStride>
__device__ __forceinline__ void load_tile(float* tile, const float* __restrict__ src, int b,
                                          int S, int H, int h, int D, int r0) {
  const int per_row = D / 4;
  const int n = kR * per_row;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int r = e / per_row;
    const int c4 = e - r * per_row;
    const int row = r0 + r;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row < S)
      v = __ldg(reinterpret_cast<const float4*>(
                    src + ((static_cast<long long>(b) * S + row) * H + h) * D) + c4);
    *reinterpret_cast<float4*>(tile + r * kStride + 4 * c4) = v;
  }
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float c) {
  c = fmaf(a.x, b.x, c);
  c = fmaf(a.y, b.y, c);
  c = fmaf(a.z, b.z, c);
  return fmaf(a.w, b.w, c);
}

// c[i][j] += sum_{d < D} A[4ty + i][d] * B[tx + 16j][d].
template <int kJ, int kStride>
__device__ __forceinline__ void dot_abt(float (&c)[4][kJ], const float* A, const float* B,
                                        int D, int ty, int tx) {
  const float* a = A + 4 * ty * kStride;
  const float* b = B + tx * kStride;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 av[4], bv[kJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = *reinterpret_cast<const float4*>(a + i * kStride + d);
#pragma unroll
    for (int j = 0; j < kJ; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + 16 * j * kStride + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kJ; ++j) c[i][j] = dot4(av[i], bv[j], c[i][j]);
  }
}

// acc[i][4jj + e] += sum_{k < kK} At[k][4ty + i] * B[k][4tx + 64jj + e],
// for the chunks 4tx + 64jj below D.
template <int kC, int kK, int kStrideB>
__device__ __forceinline__ void dot_ab(float (&acc)[4][4 * kC], const float* At, const float* B,
                                       int D, int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < kK; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(At + k * kTStride + 4 * ty);
    const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int jj = 0; jj < kC; ++jj) {
      if (4 * tx + 64 * jj < D) {
        const float4 b = *reinterpret_cast<const float4*>(B + k * kStrideB + 4 * tx + 64 * jj);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * jj] = fmaf(av[i], b.x, acc[i][4 * jj]);
          acc[i][4 * jj + 1] = fmaf(av[i], b.y, acc[i][4 * jj + 1]);
          acc[i][4 * jj + 2] = fmaf(av[i], b.z, acc[i][4 * jj + 2]);
          acc[i][4 * jj + 3] = fmaf(av[i], b.w, acc[i][4 * jj + 3]);
        }
      }
    }
  }
}

// Write the 4 x kJ values v[i][j] (rows 4ty + i, columns tx + 16j of a
// tile) transposed, into t[column][row] with row stride kTStride.
template <int kJ>
__device__ __forceinline__ void store_transposed(float* t, const float (&v)[4][kJ], int ty,
                                                 int tx) {
#pragma unroll
  for (int j = 0; j < kJ; ++j)
    *reinterpret_cast<float4*>(t + (tx + 16 * j) * kTStride + 4 * ty) =
        make_float4(v[0][j], v[1][j], v[2][j], v[3][j]);
}

// Store the 4 x 4kC accumulators of thread (ty, tx), times `mul`, as rows
// r0 + 4ty + i (those below S) of head h, batch b of a BSHD tensor, D
// columns.
template <int kC>
__device__ __forceinline__ void store_rows(float* __restrict__ dst, const float (&acc)[4][4 * kC],
                                           const float (&mul)[4], int b, int S, int H, int h,
                                           int D, int r0, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + 4 * ty + i;
    if (row >= S) continue;
    float* out = dst + ((static_cast<long long>(b) * S + row) * H + h) * D;
#pragma unroll
    for (int jj = 0; jj < kC; ++jj) {
      const int col = 4 * tx + 64 * jj;
      if (col < D)
        *reinterpret_cast<float4*>(out + col) =
            make_float4(acc[i][4 * jj] * mul[i], acc[i][4 * jj + 1] * mul[i],
                        acc[i][4 * jj + 2] * mul[i], acc[i][4 * jj + 3] * mul[i]);
    }
  }
}

template <typename K>
inline cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                              cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace f32
