// 3xTF32 building blocks of the fp32 flash kernels on the tensor cores
// (flash_fwd_f32.cu, and flash_dq_f32.cu and flash_dkv_f32.cu at widths 64
// and 128), beside hopper.cuh's barriers, TMA and descriptors.
//
// 3xTF32. A .tf32 wgmma reads 10 mantissa bits of each operand, about 1e-3
// relative: one pass is far from the fp32 products the Pallas kernels give
// on fp32 inputs. Each fp32 operand x is split into hi and lo = x - hi, and a
// product A B is the sum of three passes in the fp32 accumulator,
// hi(A) hi(B) + hi(A) lo(B) + lo(A) hi(B), which keeps all but lo(A) lo(B)
// and the bits lo itself loses (tests/test_torch_tf32x3.py emulates it on
// the CPU). Every split rounds hi to nearest (ties away from zero, as
// cvt.rna.tf32.f32), so |lo| <= 2^-11 |x| and lo is exact in fp32.
//
// Truncation. The tensor core drops the 13 low mantissa bits of an fp32
// operand rather than rounding them (tk_tf32_probe, tf32_probe.cu, settles
// it on the card, and chip_smoke.py fails if it does not hold). A raw fp32
// tile as TMA writes it would be its own hi, but a truncated one: |lo| up
// to 2^-10 |x|. So the split of a natural tile (split_natural) writes the
// rounded hi over x in place and lo beside it, which halves |lo| and cuts
// what the three passes drop, lo lo and the core's truncation of lo, about
// 4x. A tile that is split in place and also transposed (K in dQ, Q and dO
// in dK/dV) is transposed from its hi and lo, never from hi alone
// (transpose_split<..., true>), after every thread's split is done.
//
// Layout. A .tf32 operand in shared memory must be K-major: PTX gives the
// transpose bit of a wgmma descriptor to 16-bit types only. Every tile lives
// as panels of 32 floats (128 bytes) of its K dimension in the 128-byte
// swizzle, each [rows][32] with 16-byte chunk c of row r at chunk c ^ (r % 8)
// (panel_offset), which is what a TMA box of 32 fp32 x rows with
// CU_TENSOR_MAP_SWIZZLE_128B writes and what wgmma's swizzle mode 1 reads
// (hopper.cuh's kmajor_desc: SBO 1024 bytes). A k8 step is 32 bytes inside a
// panel, and the next panel follows after four steps, as a bf16 k16 step
// inside a half.
// - Natural tiles (Q, K, V, dO as TMA loads them: rows are keys or queries,
//   K is the head dim) serve S = Q K^T and dP = dO V^T (and their
//   transposes) as they stand.
// - Transposed tiles (V^T in the forward, K^T in dQ, Q^T and dO^T in dK/dV:
//   rows are the head dim, K is keys or queries) are written by
//   transpose_split from a natural tile: a tile of kN keys takes 2 kN
//   columns, hi in columns 0 .. kN - 1 and lo in kN .. 2 kN - 1, in panels
//   of kD rows.
// - Register A fragments. The m64nN f32 accumulator holds columns {2t, 2t +
//   1} of each 8-column group in thread t of a quad (hopper.cuh), the tf32 A
//   fragment of a k8 step wants columns {t, t + 4} (a0 row g column t, a1 row
//   g + 8, a2 column t + 4, a3 both; tk_tf32_probe checks it). A product
//   sums over k in any order, so the transposed tiles store key (or query) e
//   of each group of 8 at position (e >> 1) + 4 (e & 1) (tcol): the P or dS
//   accumulator is then the A fragment as it stands, a k8 step taking
//   accumulators {4j, 4j + 2, 4j + 1, 4j + 3}.
#pragma once

#include "hopper.cuh"

namespace tf32x3 {

using namespace hopper;

__device__ __forceinline__ uint32_t tf32_round(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// Split a register value: hi rounded to TF32, lo = x - hi (exact).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_round(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// Byte offset of (row r, column c) of a K-major tile of `rows` rows.
__device__ __forceinline__ uint32_t panel_offset(int rows, int r, int c) {
  return static_cast<uint32_t>((c / 32) * rows * 128 + r * 128 +
                               ((((c % 32) / 4) ^ (r % 8)) * 16) + (c % 4) * 4);
}

// Byte offset of k8 step kk (over K, the head dim) of a natural tile.
__device__ __forceinline__ uint32_t kstep(int rows, int kk) {
  return static_cast<uint32_t>((kk / 4) * rows * 128 + (kk % 4) * 32);
}

// The column of key (or query) e of a tile in its transposed tile.
__device__ __forceinline__ int tcol(int e) {
  return (e & ~7) + ((e & 7) >> 1) + 4 * (e & 1);
}

// Byte offset of the k8 step that starts at column col0 (a multiple of 8)
// of a transposed tile of kD rows.
template <int kD>
__device__ __forceinline__ uint32_t tstep(int col0) {
  return static_cast<uint32_t>((col0 / 32) * kD * 128 + ((col0 % 32) / 8) * 32);
}

// x rounded to TF32: to nearest, ties away from zero (cvt.rna.tf32.f32), as
// an fp32 value whose 13 low mantissa bits are zero.
__device__ __forceinline__ float tf32_hi(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// The split of a natural tile in place by the 128 threads of a warpgroup
// (tid 0 .. 127): each fp32 value x of the tile at x (kBytes bytes) becomes
// hi = tf32_hi(x), and lo = x - hi goes into `lo` at the same offset.
template <int kBytes>
__device__ __forceinline__ void split_natural(unsigned char* x, unsigned char* lo, int tid) {
  float4* xs = reinterpret_cast<float4*>(x);
  float4* los = reinterpret_cast<float4*>(lo);
#pragma unroll 4
  for (int i = tid; i < kBytes / 16; i += 128) {
    const float4 v = xs[i];
    const float4 h = make_float4(tf32_hi(v.x), tf32_hi(v.y), tf32_hi(v.z), tf32_hi(v.w));
    xs[i] = h;
    los[i] = make_float4(v.x - h.x, v.y - h.y, v.z - h.z, v.w - h.w);
  }
}

// The transposed split of a natural tile src [kN rows][kD] (keys or
// queries by head dim) by the 128 threads of a warpgroup: hi of (r, d) to
// (d, tcol(r)) and lo to (d, kN + tcol(r)) of dst, kD rows. With kParts the
// tile was split in place (split_natural): src holds hi and src_lo lo, at
// the same offsets, and the two are written as they stand; without it each
// x of src is split here. Thread `tid` takes row r = tid % kN and the
// float4s (r, 4 c4) for c4 = tid / kN + kStep it: a quarter warp reads
// eight rows (eight distinct chunks after the swizzle) and a warp writes
// whole rows of dst (32 consecutive columns, or two half rows four rows
// apart at kN 16), free of bank conflicts. kStep (128 / kN) is even, so
// c4 % 2, and with it the swizzle of the rows d = 4 c4 + i a thread
// writes, stays the same from one step to the next: the stores are the
// first step's addresses plus 512 kStep bytes a step.
template <int kN, int kD, bool kParts = false>
__device__ __forceinline__ void transpose_split(const unsigned char* src, unsigned char* dst,
                                                int tid, const unsigned char* src_lo = nullptr) {
  constexpr int kStep = 128 / kN;
  static_assert(kStep % 2 == 0 && (kN * kD / 4) % 128 == 0, "whole float4s a thread");
  const int r = tid % kN, c40 = tid / kN;
  const int col = tcol(r);
  uint32_t to_hi[4], to_lo[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    to_hi[i] = panel_offset(kD, 4 * c40 + i, col);
    to_lo[i] = panel_offset(kD, 4 * c40 + i, kN + col);
  }
#pragma unroll
  for (int it = 0; it < kN * kD / 512; ++it) {
    const uint32_t from = panel_offset(kN, r, 4 * (c40 + kStep * it));
    const float4 v = *reinterpret_cast<const float4*>(src + from);
    const float x[4] = {v.x, v.y, v.z, v.w};
    float y[4];
    if constexpr (kParts) {
      const float4 w = *reinterpret_cast<const float4*>(src_lo + from);
      y[0] = w.x;
      y[1] = w.y;
      y[2] = w.z;
      y[3] = w.w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t hi, lo;
      if constexpr (kParts) {
        hi = __float_as_uint(x[i]);
        lo = __float_as_uint(y[i]);
      } else {
        split(x[i], hi, lo);
      }
      *reinterpret_cast<uint32_t*>(dst + to_hi[i] + 512 * kStep * it) = hi;
      *reinterpret_cast<uint32_t*>(dst + to_lo[i] + 512 * kStep * it) = lo;
    }
  }
}

// ------------------------------------------------------------ wgmma, tf32
// f32 += tf32 x tf32 over k8, for the 128 threads of a warpgroup; the
// accumulator layout is hopper.cuh's. A scale_d of 0 overwrites d.
//
// D[64 x N] (+)= A[64 x 8] B[N x 8]^T, A and B K-major from shared memory.
__device__ __forceinline__ void wgmma_m64n8k8_tf32_ss(float (&d)[4], uint64_t desc_a,
    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n16k8_tf32_ss(float (&d)[8], uint64_t desc_a,
    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n32k8_tf32_ss(float (&d)[16], uint64_t desc_a,
    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n64k8_tf32_ss(float (&d)[32], uint64_t desc_a,
    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x N] (+)= A[64 x 8] B[N x 8]^T, A from registers (a0 .. a3 in the
// layout of the header's register A fragment), B K-major from shared memory.
__device__ __forceinline__ void wgmma_m64n8k8_tf32_rs(float (&d)[4], uint32_t a0, uint32_t a1,
    uint32_t a2, uint32_t a3, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n64k8_tf32_rs(float (&d)[32], uint32_t a0, uint32_t a1,
    uint32_t a2, uint32_t a3, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128k8_tf32_rs(float (&d)[64], uint32_t a0, uint32_t a1,
    uint32_t a2, uint32_t a3, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(scale_d));
}

// The products by accumulator size: S-like products (both operands from
// shared memory) at N = 16 .. 64, and O-like products with A from registers
// (a k8 step's four fragments) at N = 64, 128 and 256 (two of 128; the
// second on the rows 128 .. 255 of B, 16 KB further on).
__device__ __forceinline__ void mma_ss(float (&d)[8], uint64_t a, uint64_t b, int scale_d) {
  wgmma_m64n16k8_tf32_ss(d, a, b, scale_d);
}
__device__ __forceinline__ void mma_ss(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  wgmma_m64n32k8_tf32_ss(d, a, b, scale_d);
}
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  wgmma_m64n64k8_tf32_ss(d, a, b, scale_d);
}

__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t* a, uint32_t b_addr) {
  wgmma_m64n64k8_tf32_rs(d, a[0], a[1], a[2], a[3], kmajor_desc(b_addr), 1);
}
__device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t* a, uint32_t b_addr) {
  wgmma_m64n128k8_tf32_rs(d, a[0], a[1], a[2], a[3], kmajor_desc(b_addr), 1);
}
__device__ __forceinline__ void mma_rs(float (&d)[128], const uint32_t* a, uint32_t b_addr) {
  float(&lo)[64] = *reinterpret_cast<float(*)[64]>(&d[0]);
  float(&hi)[64] = *reinterpret_cast<float(*)[64]>(&d[64]);
  wgmma_m64n128k8_tf32_rs(lo, a[0], a[1], a[2], a[3], kmajor_desc(b_addr), 1);
  wgmma_m64n128k8_tf32_rs(hi, a[0], a[1], a[2], a[3], kmajor_desc(b_addr + 128 * 128), 1);
}

// The A fragments of a P-like accumulator p (kS values a thread): hi and lo
// of k8 step j in h[4j .. 4j + 3] and l[4j .. 4j + 3] (tcol's order).
template <int kS>
__device__ __forceinline__ void split_frags(const float (&p)[kS], uint32_t (&h)[kS],
                                            uint32_t (&l)[kS]) {
#pragma unroll
  for (int j = 0; j < kS / 4; ++j) {
    split(p[4 * j], h[4 * j], l[4 * j]);
    split(p[4 * j + 2], h[4 * j + 1], l[4 * j + 1]);
    split(p[4 * j + 1], h[4 * j + 2], l[4 * j + 2]);
    split(p[4 * j + 3], h[4 * j + 3], l[4 * j + 3]);
  }
}

// acc += P V over a transposed tile t of kN keys and kD rows at `t_addr`,
// three passes a k8 step: lo(P) hi(V), hi(P) lo(V), hi(P) hi(V).
template <int kN, int kD, int kAcc>
__device__ __forceinline__ void product_rs(float (&acc)[kAcc], const uint32_t (&h)[kN / 2],
                                           const uint32_t (&l)[kN / 2], uint32_t t_addr) {
#pragma unroll
  for (int kk = 0; kk < kN / 8; ++kk) {
    const uint32_t hi = t_addr + tstep<kD>(8 * kk), lo = t_addr + tstep<kD>(kN + 8 * kk);
    mma_rs(acc, &l[4 * kk], hi);
    mma_rs(acc, &h[4 * kk], lo);
    mma_rs(acc, &h[4 * kk], hi);
  }
}

// d = A B^T over the head dim (kD / 8 k8 steps) of two natural tiles, A of
// 64 rows (hi at a, lo at a_lo) and B of kRowsB rows (hi at b, lo at
// b_lo): three passes a step, lo(A) hi(B), hi(A) lo(B), hi(A) hi(B); the
// first overwrites d.
template <int kD, int kRowsB, int kS>
__device__ __forceinline__ void product_ss(float (&d)[kS], uint32_t a, uint32_t a_lo, uint32_t b,
                                           uint32_t b_lo) {
#pragma unroll
  for (int kk = 0; kk < kD / 8; ++kk) {
    const uint32_t ao = kstep(64, kk), bo = kstep(kRowsB, kk);
    mma_ss(d, kmajor_desc(a_lo + ao), kmajor_desc(b + bo), kk);
    mma_ss(d, kmajor_desc(a + ao), kmajor_desc(b_lo + bo), 1);
    mma_ss(d, kmajor_desc(a + ao), kmajor_desc(b + bo), 1);
  }
}

}  // namespace tf32x3
