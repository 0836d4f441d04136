// Flash attention backward on fp32 inputs, the dK/dV half of the
// FlashAttention-2 split (the dQ half is flash_dq_f32.cu), BSHD in and out,
// every product and sum in fp32.
//
// Replaces: tf_operator_tpu/ops/flash_pallas.py:_dkv_kernel (launched by
// _flash_backward) on fp32 inputs, where P and dS are cast to the inputs'
// dtype, fp32, before their products.
//
// Recomputes P^T = exp(scale * K Q^T - lse) a key tile at a time, with
// dP^T = V dO^T and dS^T = P^T * (dP^T - delta); dV = sum P^T dO and dK =
// scale * sum dS^T Q, summed over the query rows and over each KV head's
// group of query heads (GQA).
//
// Bound on the H100: operations. At llama-400m in fp32 (bs 8, seq 2048, 8
// heads x 128, causal) it does 4 products, 137.5 GFLOP, whose least time is
// over a third of the TF32 peak (3xTF32; device.py TF32_PASSES).
//
// Design: the simple kernel that is right (flash_f32.cuh), FMAs on the CUDA
// cores. Three instances, kD = 64, 128 and 256, serve head dims 8..64,
// 72..128 and 136..256 (multiples of 8). One block of 256 threads per (64
// keys, KV head, batch), the key tiles with the most causal rows first. The
// K and V tiles are loaded once; for each query head of the group and each
// Q/dO tile that sees a key of the block, the block computes S^T and dP^T
// (4 keys x kBlockM / 16 rows a thread each), P^T and dS^T in registers,
// writes P and dS (transposed back) to shared memory and adds P^T dO and
// dS^T Q to the dV and dK accumulators (4 keys x kD / 16 columns a thread
// each). Q tiles of 64 rows at kD 64 and 128; at 256, where K and V take
// 130 KB and the accumulators 128 registers a thread, of 32. Shared memory:
// K, V [64][kD + 4], Q, dO [kBlockM][kD + 4], P, dS [kBlockM][68] and the
// tile's lse and delta, in floats: 105 KB at kD 64, 170 KB at 128, 217 KB
// at 256.

#include "flash_f32.cuh"

namespace {

using namespace f32;

template <int kD>
struct Tiles {
  static constexpr int kBlockM = kD > 128 ? 32 : 64;  // query rows of a Q/dO tile
  static constexpr int kJ = kBlockM / 16;             // S^T columns a thread
  static constexpr int kBytes = (2 * kRows * stride<kD>() + 2 * kBlockM * stride<kD>() +
                                 2 * kBlockM * kTStride + 2 * kBlockM) * 4;
};

template <int kD>
__global__ void __launch_bounds__(kThreads, 1) flash_dkv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int B,
    int H, int KVH, int Sq, int Sk, int D, int causal, float scale) {
  constexpr int kS = stride<kD>();
  constexpr int kC = kD / 64;
  constexpr int kBlockM = Tiles<kD>::kBlockM, kJ = Tiles<kD>::kJ;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + kRows * kS;
  float* sQ = sV + kRows * kS;
  float* sdO = sQ + kBlockM * kS;
  float* sP = sdO + kBlockM * kS;
  float* sDS = sP + kBlockM * kTStride;
  float* sL = sDS + kBlockM * kTStride;  // the tile's lse * log2(e)
  float* sDl = sL + kBlockM;             // and delta

  const int bh = static_cast<int>(blockIdx.x) % (B * KVH);
  const int kt = static_cast<int>(blockIdx.x) / (B * KVH);  // most causal rows first
  const int kvh = bh % KVH, b = bh / KVH;
  const int groups = H / KVH;
  const int k0 = kt * kRows;
  const int n_q = (Sq + kBlockM - 1) / kBlockM;
  // Causal: the Q tiles before the one holding row k0 see no key of the block.
  const int q_begin = causal ? k0 / kBlockM : 0;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float c = scale * kLog2e;

  load_tile<kRows, kS>(sK, k, b, Sk, KVH, kvh, D, k0);
  load_tile<kRows, kS>(sV, v, b, Sk, KVH, kvh, D, k0);
  float dk_acc[4][4 * kC], dv_acc[4][4 * kC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4 * kC; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.0f;

  for (int g = 0; g < groups; ++g) {
    const int h = kvh * groups + g;
    const long long rows = (static_cast<long long>(b) * H + h) * Sq;
    for (int qt = q_begin; qt < n_q; ++qt) {
      const int q0 = qt * kBlockM;
      __syncthreads();  // the last tile's Q, dO, P, dS, lse and delta are done with
      load_tile<kBlockM, kS>(sQ, q, b, Sq, H, h, D, q0);
      load_tile<kBlockM, kS>(sdO, dout, b, Sq, H, h, D, q0);
      if (threadIdx.x < kBlockM) {
        const int row = q0 + threadIdx.x;
        sL[threadIdx.x] = row < Sq ? lse[rows + row] * kLog2e : 0.0f;
        sDl[threadIdx.x] = row < Sq ? delta[rows + row] : 0.0f;
      }
      __syncthreads();
      float st[4][kJ], dpt[4][kJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < kJ; ++jj) st[i][jj] = dpt[i][jj] = 0.0f;
      dot_abt<kJ, kS>(st, sK, sQ, D, ty, tx);
      dot_abt<kJ, kS>(dpt, sV, sdO, D, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < kJ; ++jj) {
          const int r = tx + 16 * jj;
          const int key = k0 + 4 * ty + i, row = q0 + r;
          const bool seen = row < Sq && key < Sk && !(causal && key > row);
          const float p = seen ? exp2f(fmaf(st[i][jj], c, -sL[r])) : 0.0f;
          st[i][jj] = p;
          dpt[i][jj] = p * (dpt[i][jj] - sDl[r]);  // dS^T
        }
      store_transposed<kJ>(sP, st, ty, tx);
      store_transposed<kJ>(sDS, dpt, ty, tx);
      __syncthreads();
      dot_ab<kC, kBlockM, kS>(dv_acc, sP, sdO, D, ty, tx);
      dot_ab<kC, kBlockM, kS>(dk_acc, sDS, sQ, D, ty, tx);
    }
  }

  const float one[4] = {1.0f, 1.0f, 1.0f, 1.0f};
  const float mul[4] = {scale, scale, scale, scale};
  store_rows<kC>(dk, dk_acc, mul, b, Sk, KVH, kvh, D, k0, ty, tx);
  store_rows<kC>(dv, dv_acc, one, b, Sk, KVH, kvh, D, k0, ty, tx);
}

template <int kD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dk, void* dv, int B, int H,
                   int KVH, int Sq, int Sk, int D, int causal, float scale, void* stream) {
  constexpr int kBytes = Tiles<kD>::kBytes;
  const cudaError_t err = allow_smem(flash_dkv_f32_kernel<kD>, kBytes);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>((Sk + kRows - 1) / kRows) * B * KVH;
  flash_dkv_f32_kernel<kD><<<blocks, kThreads, kBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv), B, H,
      KVH, Sq, Sk, D, causal, scale);
  return cudaSuccess;
}

}  // namespace

extern "C" int tk_flash_dkv_f32(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dk, void* dv, int B,
                                int H, int KVH, int Sq, int Sk, int D, int causal, float scale,
                                void* stream) {
  // Head dims that are a multiple of 8 from 8 to 256 (ops/flash.py refuses
  // every other before it calls).
  cudaError_t err = cudaErrorInvalidValue;
  if (D % 8 == 0 && D >= 8 && D <= 64)
    err = launch<64>(q, k, v, dout, lse, delta, dk, dv, B, H, KVH, Sq, Sk, D, causal, scale,
                     stream);
  else if (D % 8 == 0 && D > 64 && D <= 128)
    err = launch<128>(q, k, v, dout, lse, delta, dk, dv, B, H, KVH, Sq, Sk, D, causal, scale,
                      stream);
  else if (D % 8 == 0 && D > 128 && D <= 256)
    err = launch<256>(q, k, v, dout, lse, delta, dk, dv, B, H, KVH, Sq, Sk, D, causal, scale,
                      stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  TK_RETURN_LAST_ERROR();
}
