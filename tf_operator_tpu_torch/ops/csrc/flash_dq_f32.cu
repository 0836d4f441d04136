// Flash attention backward on fp32 inputs, the dQ half of the
// FlashAttention-2 split (the dK/dV half is flash_dkv_f32.cu), BSHD in and
// out, every product and sum in fp32.
//
// Replaces: tf_operator_tpu/ops/flash_pallas.py:_dq_kernel (launched by
// _flash_backward) on fp32 inputs, where dS is cast to the inputs' dtype,
// fp32, before its product.
//
// Recomputes P = exp(scale * Q K^T - lse) from the forward's per-row
// logsumexp, with dP = dO V^T and dS = P * (dP - delta), where delta =
// rowsum(dO * O) - dlse is computed by the caller in plain torch; dQ =
// scale * sum dS K.
//
// Bound on the H100: operations. At llama-400m in fp32 (bs 8, seq 2048, 8
// heads x 128, causal) it does 3 products, 103.1 GFLOP, whose least time is
// over a third of the TF32 peak (3xTF32; device.py TF32_PASSES).
//
// Design: the simple kernel that is right (flash_f32.cuh), FMAs on the CUDA
// cores. Three instances, kD = 64, 128 and 256, serve head dims 8..64,
// 72..128 and 136..256 (multiples of 8). One block of 256 threads per (64 Q
// rows, q head, batch), the longest causal blocks first; each thread keeps
// its 4 rows' lse and delta in registers. The Q and dO tiles are loaded
// once; for each K/V tile the block computes S and dP (4 x kBlockN / 16 a
// thread each), dS in registers, writes dS transposed to shared memory and
// adds dS K to the dQ accumulator (4 rows x kD / 16 columns a thread).
// Key tiles of 64 at kD 64 and 128; at 256, where Q and dO take 133 KB,
// of 32. Shared memory: Q, dO [64][kD + 4], K, V [kBlockN][kD + 4] and dS
// [kBlockN][68] floats: 87 KB at kD 64, 153 KB at 128, 208 KB at 256.

#include "flash_f32.cuh"

namespace {

using namespace f32;

template <int kD>
struct Tiles {
  static constexpr int kBlockN = kD > 128 ? 32 : 64;  // keys of a K/V tile
  static constexpr int kJ = kBlockN / 16;            // S columns a thread
  static constexpr int kBytes = (2 * kRows * stride<kD>() + 2 * kBlockN * stride<kD>() +
                                 kBlockN * kTStride) * 4;
};

template <int kD>
__global__ void __launch_bounds__(kThreads, 1) flash_dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int B, int H, int KVH, int Sq,
    int Sk, int D, int causal, float scale) {
  constexpr int kS = stride<kD>();
  constexpr int kC = kD / 64;
  constexpr int kBlockN = Tiles<kD>::kBlockN, kJ = Tiles<kD>::kJ;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sdO = sQ + kRows * kS;
  float* sK = sdO + kRows * kS;
  float* sV = sK + kBlockN * kS;
  float* sDS = sV + kBlockN * kS;

  const int n_q = (Sq + kRows - 1) / kRows;
  const int bh = static_cast<int>(blockIdx.x) % (B * H);
  const int qt = n_q - 1 - static_cast<int>(blockIdx.x) / (B * H);  // longest first
  const int h = bh % H, b = bh / H;
  const int kvh = h / (H / KVH);
  const int q0 = qt * kRows;
  const int n_k = (Sk + kBlockN - 1) / kBlockN;
  const int k_end = causal ? min(n_k, (q0 + kRows + kBlockN - 1) / kBlockN) : n_k;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float c = scale * kLog2e;

  load_tile<kRows, kS>(sQ, q, b, Sq, H, h, D, q0);
  load_tile<kRows, kS>(sdO, dout, b, Sq, H, h, D, q0);
  float lse2[4], dl[4], acc[4][4 * kC];
  const long long rows = (static_cast<long long>(b) * H + h) * Sq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    lse2[i] = row < Sq ? lse[rows + row] * kLog2e : 0.0f;
    dl[i] = row < Sq ? delta[rows + row] : 0.0f;
#pragma unroll
    for (int e = 0; e < 4 * kC; ++e) acc[i][e] = 0.0f;
  }

  for (int j = 0; j < k_end; ++j) {
    const int k0 = j * kBlockN;
    __syncthreads();  // the last tile's K, V and dS are done with
    load_tile<kBlockN, kS>(sK, k, b, Sk, KVH, kvh, D, k0);
    load_tile<kBlockN, kS>(sV, v, b, Sk, KVH, kvh, D, k0);
    __syncthreads();
    float s[4][kJ], dp[4][kJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) s[i][jj] = dp[i][jj] = 0.0f;
    dot_abt<kJ, kS>(s, sQ, sK, D, ty, tx);
    dot_abt<kJ, kS>(dp, sdO, sV, D, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) {
        const int col = k0 + tx + 16 * jj, row = q0 + 4 * ty + i;
        const bool seen = row < Sq && col < Sk && !(causal && col > row);
        const float p = seen ? exp2f(fmaf(s[i][jj], c, -lse2[i])) : 0.0f;
        s[i][jj] = p * (dp[i][jj] - dl[i]);  // dS
      }
    store_transposed<kJ>(sDS, s, ty, tx);
    __syncthreads();
    dot_ab<kC, kBlockN, kS>(acc, sDS, sK, D, ty, tx);
  }

  const float mul[4] = {scale, scale, scale, scale};
  store_rows<kC>(dq, acc, mul, b, Sq, H, h, D, q0, ty, tx);
}

template <int kD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dq, int B, int H, int KVH, int Sq,
                   int Sk, int D, int causal, float scale, void* stream) {
  constexpr int kBytes = Tiles<kD>::kBytes;
  const cudaError_t err = allow_smem(flash_dq_f32_kernel<kD>, kBytes);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>((Sq + kRows - 1) / kRows) * B * H;
  flash_dq_f32_kernel<kD><<<blocks, kThreads, kBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), B, H, KVH, Sq, Sk, D, causal,
      scale);
  return cudaSuccess;
}

}  // namespace

extern "C" int tk_flash_dq_f32(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, void* dq, int B, int H,
                               int KVH, int Sq, int Sk, int D, int causal, float scale,
                               void* stream) {
  // Head dims that are a multiple of 8 from 8 to 256 (ops/flash.py refuses
  // every other before it calls).
  cudaError_t err = cudaErrorInvalidValue;
  if (D % 8 == 0 && D >= 8 && D <= 64)
    err = launch<64>(q, k, v, dout, lse, delta, dq, B, H, KVH, Sq, Sk, D, causal, scale,
                     stream);
  else if (D % 8 == 0 && D > 64 && D <= 128)
    err = launch<128>(q, k, v, dout, lse, delta, dq, B, H, KVH, Sq, Sk, D, causal, scale,
                      stream);
  else if (D % 8 == 0 && D > 128 && D <= 256)
    err = launch<256>(q, k, v, dout, lse, delta, dq, B, H, KVH, Sq, Sk, D, causal, scale,
                      stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  TK_RETURN_LAST_ERROR();
}
