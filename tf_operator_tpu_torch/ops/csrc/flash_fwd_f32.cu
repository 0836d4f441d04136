// Flash attention forward on fp32 inputs: o and the per-row logsumexp, BSHD
// in and out, every product and sum in fp32.
//
// Replaces: tf_operator_tpu/ops/flash_pallas.py:_flash_kernel (launched by
// _flash_forward) on fp32 q, k and v, where the Pallas kernel keeps the
// products in fp32 (P is cast to the inputs' dtype, fp32, before P V).
//
// Computes causal or full attention with GQA and an online softmax: s =
// Q K^T; the running max m, denominator l and the O accumulator carry
// across K/V tiles; o = acc / l (l == 0 -> 1) and lse = scale * m + log l.
//
// Bound on the H100: operations. At llama-400m in fp32 (bs 8, seq 2048, 8
// heads x 128, causal: 68.75 GFLOP against 268 MB) the least time is the
// FLOPs over a third of the TF32 peak, the rate at which the tensor cores
// give fp32-accurate products (3xTF32; device.py TF32_PASSES).
//
// Design: the simple kernel that is right (flash_f32.cuh). FMAs on the CUDA
// cores at fp32's full accuracy, so far slower than that bound. Three
// instances, kD = 64, 128 and 256, serve head dims 8..64, 72..128 and
// 136..256 (multiples of 8). One block of 256 threads per (64 Q rows, q
// head, batch), the longest causal blocks first. The Q tile is loaded
// once; for each 64-key tile the block loads K and V, computes S (4 x 4 a
// thread), runs the online softmax on its registers (a row's 16 owners
// reduce by shuffles), writes P transposed to shared memory and adds P V
// to the accumulator (4 rows x kD / 16 columns a thread). Causal: K tiles
// past the block's last row are never loaded and only the tiles that cross
// the diagonal or the ragged end of the keys are masked. Shared memory:
// Q, K, V of [64][kD + 4] and P of [64][68] floats: 69 KB at kD 64, 118 KB
// at 128 and 217 KB at 256.

#include "flash_f32.cuh"

namespace {

using namespace f32;

constexpr int kBlockN = 64;           // keys of a K/V tile
constexpr int kJ = kBlockN / 16;      // S columns a thread

template <int kD>
constexpr int smem_bytes() {
  return (3 * kRows * stride<kD>() + kBlockN * kTStride) * 4;
}

template <int kD>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, float* __restrict__ lse, int B, int H, int KVH, int Sq, int Sk,
    int D, int causal, float scale) {
  constexpr int kS = stride<kD>();
  constexpr int kC = kD / 64;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + kRows * kS;
  float* sV = sK + kBlockN * kS;
  float* sP = sV + kBlockN * kS;

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
  float acc[4][4 * kC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int e = 0; e < 4 * kC; ++e) acc[i][e] = 0.0f;
  }

  for (int j = 0; j < k_end; ++j) {
    const int k0 = j * kBlockN;
    __syncthreads();  // the last tile's K, V and P are done with
    load_tile<kBlockN, kS>(sK, k, b, Sk, KVH, kvh, D, k0);
    load_tile<kBlockN, kS>(sV, v, b, Sk, KVH, kvh, D, k0);
    __syncthreads();
    float s[4][kJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) s[i][jj] = 0.0f;
    dot_abt<kJ, kS>(s, sQ, sK, D, ty, tx);
    if ((causal && k0 + kBlockN - 1 > q0) || k0 + kBlockN > Sk) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < kJ; ++jj) {
          const int col = k0 + tx + 16 * jj, row = q0 + 4 * ty + i;
          if (col >= Sk || (causal && col > row)) s[i][jj] = -INFINITY;
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = m[i];
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) mx = fmaxf(mx, s[i][jj]);
      mx = row_max(mx);
      // A row with nothing visible yet keeps max -inf: subtract 0 instead
      // of -inf so that exp2 gives 0, not nan.
      const float ms = mx == -INFINITY ? 0.0f : mx * c;
      const float alpha = exp2f(m[i] * c - ms);
      m[i] = mx;
      float sum = 0.0f;
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) {
        s[i][jj] = exp2f(fmaf(s[i][jj], c, -ms));
        sum += s[i][jj];
      }
      l[i] = l[i] * alpha + sum;  // this thread's columns; the row sums at the end
#pragma unroll
      for (int e = 0; e < 4 * kC; ++e) acc[i][e] *= alpha;
    }
    store_transposed<kJ>(sP, s, ty, tx);
    __syncthreads();
    dot_ab<kC, kBlockN, kS>(acc, sP, sV, D, ty, tx);
  }

  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    l[i] = row_sum(l[i]);
    if (l[i] == 0.0f) l[i] = 1.0f;
    inv[i] = 1.0f / l[i];
  }
  store_rows<kC>(o, acc, inv, b, Sq, H, h, D, q0, ty, tx);
  if (tx == 0) {
    float* out = lse + (static_cast<long long>(b) * H + h) * Sq;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      if (row < Sq) out[row] = m[i] * scale + logf(l[i]);
    }
  }
}

template <int kD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                   int H, int KVH, int Sq, int Sk, int D, int causal, float scale,
                   void* stream) {
  constexpr int kBytes = smem_bytes<kD>();
  const cudaError_t err = allow_smem(flash_fwd_f32_kernel<kD>, kBytes);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>((Sq + kRows - 1) / kRows) * B * H;
  flash_fwd_f32_kernel<kD><<<blocks, kThreads, kBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), B, H, KVH, Sq, Sk, D, causal, scale);
  return cudaSuccess;
}

}  // namespace

extern "C" int tk_flash_fwd_f32(const void* q, const void* k, const void* v, void* o,
                                void* lse, int B, int H, int KVH, int Sq, int Sk, int D,
                                int causal, float scale, void* stream) {
  // Head dims that are a multiple of 8 from 8 to 256 (ops/flash.py refuses
  // every other before it calls).
  cudaError_t err = cudaErrorInvalidValue;
  if (D % 8 == 0 && D >= 8 && D <= 64)
    err = launch<64>(q, k, v, o, lse, B, H, KVH, Sq, Sk, D, causal, scale, stream);
  else if (D % 8 == 0 && D > 64 && D <= 128)
    err = launch<128>(q, k, v, o, lse, B, H, KVH, Sq, Sk, D, causal, scale, stream);
  else if (D % 8 == 0 && D > 128 && D <= 256)
    err = launch<256>(q, k, v, o, lse, B, H, KVH, Sq, Sk, D, causal, scale, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  TK_RETURN_LAST_ERROR();
}
