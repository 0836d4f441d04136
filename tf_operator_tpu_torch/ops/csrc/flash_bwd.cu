// Flash attention backward: the FlashAttention-2 split into a dQ kernel and
// a dK/dV kernel, BSHD in and out.
//
// Replaces: tf_operator_tpu/ops/flash_pallas.py:_dq_kernel and _dkv_kernel
// (both launched by _flash_backward).
//
// Both recompute P = exp(scale * Q K^T - lse) from the forward's per-row
// logsumexp (no stored s x s matrix), with dP = dO V^T and
// dS = P * (dP - delta), where delta = rowsum(dO * O) - dlse is computed by
// the caller in plain torch. dS and P are cast to bf16 before their
// products; every sum is fp32.
//
// Bound on the H100: operations. At llama-400m (bs 8, seq 2048, 8 heads x
// 128, causal) dQ does 3 products (103 GFLOP) and dK/dV 4 (137 GFLOP).
//
// dQ design: one block per (q tile, q head, batch), looping over the K/V
// tiles up to the diagonal like the forward; dQ accumulates in tensor-core
// fragments (registers) and is written once.
//
// dK/dV design: one block per (k tile, KV head, batch). The inner loops run
// over the group's query heads and the Q tiles from the diagonal on, so the
// grouped query heads sum into their KV head inside the block: dK and dV are
// written once, with no atomics and no extra reduction pass. The block works
// in the transposed frame (S^T = K Q^T, dP^T = V dO^T), so each warp owns 16
// K rows end to end and dV += P^T dO, dK += dS^T Q need no transpose.

#include "flash_common.cuh"

namespace flash {
namespace {

template <int D>
constexpr int bwd_smem_bytes() {
  using L = Layout<D>;
  return 4 * L::tile_bytes + 2 * L::score_bytes + L::prob_bytes + 2 * L::row_bytes;
}

// Per-row statistics of a Q tile (lse, delta) into shared memory; padding
// rows get 0 (their probabilities are masked or multiply zero rows).
__device__ __forceinline__ void load_rows(float* lse_s, float* delta_s,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ delta,
                                          long long base, int valid) {
  if (threadIdx.x < kTile) {
    const bool in = threadIdx.x < valid;
    lse_s[threadIdx.x] = in ? lse[base + threadIdx.x] : 0.0f;
    delta_s[threadIdx.x] = in ? delta[base + threadIdx.x] : 0.0f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2) flash_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int H, int KVH, int Sq, int Sk, int causal, float scale) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + kTile * L::ld;
  bf16* Ks = dOs + kTile * L::ld;
  bf16* Vs = Ks + kTile * L::ld;
  float* Ss = reinterpret_cast<float*>(Vs + kTile * L::ld);
  float* dPs = Ss + kTile * kLdS;
  bf16* dSs = reinterpret_cast<bf16*>(dPs + kTile * kLdS);
  float* Lse = reinterpret_cast<float*>(dSs + kTile * kLdP);
  float* Dl = Lse + kTile;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int q0 = qt * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  const long long q_row = static_cast<long long>(H) * D;
  const long long kv_row = static_cast<long long>(KVH) * D;
  const long long q_off = (static_cast<long long>(b) * Sq + q0) * q_row + h * D;

  load_tile<D>(Qs, q + q_off, q_row, Sq - q0);
  load_tile<D>(dOs, dout + q_off, q_row, Sq - q0);
  load_rows(Lse, Dl, lse, delta, (static_cast<long long>(b) * H + h) * Sq + q0, Sq - q0);

  FragC acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(acc[n], 0.0f);

  const int n_k = (Sk + kTile - 1) / kTile;
  const int k_end = causal ? min(n_k, qt + 1) : n_k;
  for (int kt = 0; kt < k_end; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    const long long off = (static_cast<long long>(b) * Sk + k0) * kv_row + kvh * D;
    load_tile<D>(Ks, k + off, kv_row, Sk - k0);
    load_tile<D>(Vs, v + off, kv_row, Sk - k0);
    __syncthreads();

    warp_abt<D>(Qs + r0 * L::ld, Ks, Ss + r0 * kLdS);    // S = Q K^T
    warp_abt<D>(dOs + r0 * L::ld, Vs, dPs + r0 * kLdS);  // dP = dO V^T
    __syncwarp();

    for (int r = 0; r < 16; ++r) {
      const int row = r0 + r;
      const int qi = q0 + row;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int c = lane + 32 * t;
        const int kj = k0 + c;
        float s = scale * Ss[row * kLdS + c];
        if (kj >= Sk || (causal && qi < kj)) s = kMask;
        const float p = __expf(s - Lse[row]);
        dSs[row * kLdP + c] = __float2bfloat16(p * (dPs[row * kLdS + c] - Dl[row]));
      }
    }
    __syncwarp();
    warp_pb<D>(acc, dSs + r0 * kLdP, Ks);  // dQ += dS K
  }

  __syncthreads();  // every warp is done with the tiles: reuse them for dQ
  float* out = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(out + r0 * L::ldo + n * 16, acc[n], L::ldo, wmma::mem_row_major);
  __syncwarp();
  store_rows<D>(dq + q_off, q_row, out, r0, Sq - q0, scale);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2) flash_dkv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int KVH, int Sq, int Sk,
    int causal, float scale) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kTile * L::ld;
  bf16* Qs = Vs + kTile * L::ld;
  bf16* dOs = Qs + kTile * L::ld;
  float* St = reinterpret_cast<float*>(dOs + kTile * L::ld);  // S^T, then dS^T
  float* dPt = St + kTile * kLdS;
  bf16* Pt = reinterpret_cast<bf16*>(dPt + kTile * kLdS);     // P^T, then dS^T
  float* Lse = reinterpret_cast<float*>(Pt + kTile * kLdP);
  float* Dl = Lse + kTile;

  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int groups = H / KVH;
  const int k0 = kt * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  const long long q_row = static_cast<long long>(H) * D;
  const long long kv_row = static_cast<long long>(KVH) * D;
  const long long kv_off = (static_cast<long long>(b) * Sk + k0) * kv_row + kvh * D;

  load_tile<D>(Ks, k + kv_off, kv_row, Sk - k0);
  load_tile<D>(Vs, v + kv_off, kv_row, Sk - k0);

  FragC dk_acc[D / 16], dv_acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fill_fragment(dk_acc[n], 0.0f);
    wmma::fill_fragment(dv_acc[n], 0.0f);
  }

  const int n_q = (Sq + kTile - 1) / kTile;
  // Causal: Q tiles before the diagonal see none of this K tile.
  const int q_begin = causal ? kt : 0;
  for (int g = 0; g < groups; ++g) {
    const int h = kvh * groups + g;
    for (int qt = q_begin; qt < n_q; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();  // every warp is done with the previous Q tile
      const long long q_off = (static_cast<long long>(b) * Sq + q0) * q_row + h * D;
      load_tile<D>(Qs, q + q_off, q_row, Sq - q0);
      load_tile<D>(dOs, dout + q_off, q_row, Sq - q0);
      load_rows(Lse, Dl, lse, delta, (static_cast<long long>(b) * H + h) * Sq + q0,
                Sq - q0);
      __syncthreads();

      warp_abt<D>(Ks + r0 * L::ld, Qs, St + r0 * kLdS);    // S^T = K Q^T
      warp_abt<D>(Vs + r0 * L::ld, dOs, dPt + r0 * kLdS);  // dP^T = V dO^T
      __syncwarp();

      for (int r = 0; r < 16; ++r) {
        const int row = r0 + r;  // K row of the tile
        const int kj = k0 + row;
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int c = lane + 32 * t;  // Q row of the tile
          const int qi = q0 + c;
          float s = scale * St[row * kLdS + c];
          if (qi >= Sq || (causal && qi < kj)) s = kMask;
          const float p = __expf(s - Lse[c]);
          Pt[row * kLdP + c] = __float2bfloat16(p);
          St[row * kLdS + c] = p * (dPt[row * kLdS + c] - Dl[c]);
        }
      }
      __syncwarp();
      warp_pb<D>(dv_acc, Pt + r0 * kLdP, dOs);  // dV += P^T dO
      __syncwarp();
      for (int r = 0; r < 16; ++r) {
        const int row = r0 + r;
        Pt[row * kLdP + lane] = __float2bfloat16(St[row * kLdS + lane]);
        Pt[row * kLdP + lane + 32] = __float2bfloat16(St[row * kLdS + lane + 32]);
      }
      __syncwarp();
      warp_pb<D>(dk_acc, Pt + r0 * kLdP, Qs);  // dK += dS^T Q
    }
  }

  __syncthreads();  // every warp is done with the tiles: reuse them for dK/dV
  float* out = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(out + r0 * L::ldo + n * 16, dk_acc[n], L::ldo,
                            wmma::mem_row_major);
  __syncwarp();
  store_rows<D>(dk + kv_off, kv_row, out, r0, Sk - k0, scale);
  __syncwarp();
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(out + r0 * L::ldo + n * 16, dv_acc[n], L::ldo,
                            wmma::mem_row_major);
  __syncwarp();
  store_rows<D>(dv + kv_off, kv_row, out, r0, Sk - k0, 1.0f);
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int H, int KVH,
              int Sq, int Sk, int causal, float scale, cudaStream_t stream) {
  constexpr int smem = bwd_smem_bytes<D>();
  cudaError_t err = allow_smem(flash_dq_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kTile - 1) / kTile, H, B);
  flash_dq_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), H, KVH, Sq, Sk, causal, scale);
  TK_RETURN_LAST_ERROR();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int B, int H,
               int KVH, int Sq, int Sk, int causal, float scale, cudaStream_t stream) {
  constexpr int smem = bwd_smem_bytes<D>();
  cudaError_t err = allow_smem(flash_dkv_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sk + kTile - 1) / kTile, KVH, B);
  flash_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, KVH, Sq, Sk, causal, scale);
  TK_RETURN_LAST_ERROR();
}

}  // namespace
}  // namespace flash

extern "C" {

int tk_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* delta, void* dq, int B, int H, int KVH,
                int Sq, int Sk, int D, int causal, float scale, void* stream) {
  if (D != 128) return static_cast<int>(cudaErrorInvalidValue);
  return flash::launch_dq<128>(q, k, v, dout, lse, delta, dq, B, H, KVH, Sq, Sk,
                               causal, scale, static_cast<cudaStream_t>(stream));
}

int tk_flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* delta, void* dk, void* dv, int B, int H,
                 int KVH, int Sq, int Sk, int D, int causal, float scale,
                 void* stream) {
  if (D != 128) return static_cast<int>(cudaErrorInvalidValue);
  return flash::launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, B, H, KVH, Sq,
                                Sk, causal, scale, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
