// Flash attention forward: o and the per-row logsumexp, BSHD in and out.
//
// Replaces: tf_operator_tpu/ops/flash_pallas.py:_flash_kernel (launched by
// _flash_forward).
//
// Computes causal or full attention with GQA and an online softmax: scores
// are scale * Q K^T in fp32 from bf16 operands, masked with -1e30; the
// running max m, denominator l and an fp32 accumulator carry across K/V
// tiles; P is cast to bf16 before P V; o = acc / l (l == 0 -> 1) and
// lse = m + log l.
//
// Bound on the H100: operations. At llama-400m (bs 8, seq 2048, 8 heads x
// 128, causal) it does 68.7 GFLOP against 67 MB of traffic. Design: one
// block per (q tile of 64 rows, q head, batch); it keeps its Q tile in
// shared memory and loops over the K/V tiles up to the diagonal, so the
// s x s score matrix never reaches device memory and tiles above the
// diagonal are never read. K/V are read at KV head h / groups (GQA without
// a repeat) straight through BSHD strides (no transposed copies). Products
// run on the tensor cores (WMMA, bf16 in, fp32 out); the softmax runs on
// the warp's own 16 rows in shared memory. Shared memory is 110 KB at
// head_dim 128, so two blocks fit an SM.

#include "flash_common.cuh"

namespace flash {
namespace {

template <int D>
constexpr int fwd_smem_bytes() {
  using L = Layout<D>;
  return 3 * L::tile_bytes + L::score_bytes + L::prob_bytes + L::acc_bytes +
         2 * L::row_bytes;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2) flash_fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
    int H, int KVH, int Sq, int Sk, int causal, float scale) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kTile * L::ld;
  bf16* Vs = Ks + kTile * L::ld;
  float* Ss = reinterpret_cast<float*>(Vs + kTile * L::ld);
  bf16* Ps = reinterpret_cast<bf16*>(Ss + kTile * kLdS);
  float* Os = reinterpret_cast<float*>(Ps + kTile * kLdP);
  float* Ms = Os + kTile * L::ldo;
  float* Ls = Ms + kTile;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int q0 = qt * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  const long long q_row = static_cast<long long>(H) * D;
  const long long kv_row = static_cast<long long>(KVH) * D;

  load_tile<D>(Qs, q + (static_cast<long long>(b) * Sq + q0) * q_row + h * D, q_row,
               Sq - q0);
  for (int i = threadIdx.x; i < kTile * L::ldo; i += kThreads) Os[i] = 0.0f;
  if (threadIdx.x < kTile) {
    Ms[threadIdx.x] = kMask;
    Ls[threadIdx.x] = 0.0f;
  }

  const int n_k = (Sk + kTile - 1) / kTile;
  // Causal: K tiles strictly above the diagonal are invisible to every row.
  const int k_end = causal ? min(n_k, qt + 1) : n_k;
  for (int kt = 0; kt < k_end; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // every warp is done with the previous K/V tile
    const long long off = (static_cast<long long>(b) * Sk + k0) * kv_row + kvh * D;
    load_tile<D>(Ks, k + off, kv_row, Sk - k0);
    load_tile<D>(Vs, v + off, kv_row, Sk - k0);
    __syncthreads();

    warp_abt<D>(Qs + r0 * L::ld, Ks, Ss + r0 * kLdS);
    __syncwarp();

    for (int r = 0; r < 16; ++r) {
      const int row = r0 + r;
      const int qi = q0 + row;
      float s[2];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int c = lane + 32 * t;
        const int kj = k0 + c;
        const float val = scale * Ss[row * kLdS + c];
        s[t] = (kj >= Sk || (causal && qi < kj)) ? kMask : val;
      }
      const float m_prev = Ms[row];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s[0], s[1])));
      const float alpha = __expf(m_prev - m_new);
      const float p0 = __expf(s[0] - m_new);
      const float p1 = __expf(s[1] - m_new);
      Ps[row * kLdP + lane] = __float2bfloat16(p0);
      Ps[row * kLdP + lane + 32] = __float2bfloat16(p1);
      const float psum = warp_sum(p0 + p1);
      for (int c = lane; c < D; c += 32) Os[row * L::ldo + c] *= alpha;
      __syncwarp();  // every lane has read Ms[row] before it changes
      if (lane == 0) {
        Ms[row] = m_new;
        Ls[row] = alpha * Ls[row] + psum;
      }
    }
    __syncwarp();

    // O += P V on this warp's rows, the fp32 accumulator kept in shared
    // memory (the per-row rescale above needs its row layout).
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      FragC acc;
      float* dst = Os + r0 * L::ldo + n * 16;
      wmma::load_matrix_sync(acc, dst, L::ldo, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        FragA a;
        FragB bv;
        wmma::load_matrix_sync(a, Ps + r0 * kLdP + kk * 16, kLdP);
        wmma::load_matrix_sync(bv, Vs + kk * 16 * L::ld + n * 16, L::ld);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(dst, acc, L::ldo, wmma::mem_row_major);
    }
    __syncwarp();
  }

  for (int r = 0; r < 16; ++r) {
    const int row = r0 + r;
    const int qi = q0 + row;
    if (qi >= Sq) break;
    const float l = Ls[row] == 0.0f ? 1.0f : Ls[row];
    bf16* orow = o + (static_cast<long long>(b) * Sq + qi) * q_row + h * D;
    for (int c = lane; c < D; c += 32)
      orow[c] = __float2bfloat16(Os[row * L::ldo + c] / l);
    if (lane == 0)
      lse[(static_cast<long long>(b) * H + h) * Sq + qi] = Ms[row] + logf(l);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int B,
           int H, int KVH, int Sq, int Sk, int causal, float scale,
           cudaStream_t stream) {
  constexpr int smem = fwd_smem_bytes<D>();
  cudaError_t err = allow_smem(flash_fwd_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kTile - 1) / kTile, H, B);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), static_cast<float*>(lse),
      H, KVH, Sq, Sk, causal, scale);
  TK_RETURN_LAST_ERROR();
}

}  // namespace
}  // namespace flash

extern "C" int tk_flash_fwd(const void* q, const void* k, const void* v, void* o,
                            void* lse, int B, int H, int KVH, int Sq, int Sk, int D,
                            int causal, float scale, void* stream) {
  if (D != 128) return static_cast<int>(cudaErrorInvalidValue);
  return flash::launch<128>(q, k, v, o, lse, B, H, KVH, Sq, Sk, causal, scale,
                            static_cast<cudaStream_t>(stream));
}
