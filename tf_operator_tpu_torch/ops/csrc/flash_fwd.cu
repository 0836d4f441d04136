// Flash attention forward: o and the per-row logsumexp, BSHD in and out.
//
// Replaces: tf_operator_tpu/ops/flash_pallas.py:_flash_kernel (launched by
// _flash_forward).
//
// Computes causal or full attention with GQA and an online softmax: scores
// s = Q K^T in fp32 from bf16 operands; the running max m, denominator l
// and an fp32 accumulator carry across K/V tiles; P is cast to bf16 before
// P V; o = acc / l (l == 0 -> 1) and lse = scale * m + log l.
//
// Bound on the H100: operations at llama-400m (bs 8, seq 2048, 8 heads x
// 128, causal: 68.75 GFLOP against 135 MB of traffic); bytes at bert-base
// (bs 16, seq 512, 12 heads x 64, non-causal: 12.9 GFLOP, 50.7 MB).
//
// Design (sm_90a, the building blocks in hopper.cuh). One kernel for each
// head_dim, 64 and 128 (the template argument kD). One block per (128 Q
// rows, q head, batch): two warpgroups of 64 Q rows each.
// - Thread 0 loads the block's Q tile once and streams the K and V tiles
//   (128 keys each) by TMA into a 3-stage ring, one tile ahead of its use,
//   each stage completing on an mbarrier; the warpgroups free a stage
//   through a second mbarrier. So tile j + 1 loads while tile j computes.
// - S = Q K^T is wgmma m64n128k16 with both operands K-major from the
//   swizzled tiles. The softmax runs on the accumulator registers: each
//   thread holds two rows, the row max and sum take two quad shuffles, and
//   exp2 runs with scale * log2(e) folded into one multiply. The O
//   accumulator (64 fp32 a thread) is rescaled in registers. O += P V is
//   wgmma with P from registers (the S accumulator cast to bf16 pairs is
//   the A fragment) and V MN-major from shared memory: m64n128k16 at
//   head_dim 128, m64n64k16 (32 fp32 a thread) at 64.
// - Causal: K tiles past the block's last row are never loaded, only tiles
//   that cross the diagonal (or the ragged end of the keys) are masked, and
//   the blocks with the most tiles launch first.
// - Epilogue: o = acc / l in registers, to bf16, staged in the warpgroup's
//   own Q rows and written by TMA store (rows past the end are not
//   written); lse from registers.
// Shared memory 225 KB at head_dim 128 (113 KB at 64): one block an SM. GQA by index (K/V at head
// h / groups), no copies of K/V. With 128 Q rows a block, every block
// streams its K/V tiles from L2 (570 MB a call at llama-400m); that stream,
// not the products or the softmax, sets most of the time (PERF.md).

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kRowsWG = 64;                   // Q rows of a consumer warpgroup
constexpr int kConsumers = 2;                 // consumer warpgroups
constexpr int kBlockM = kRowsWG * kConsumers; // Q rows of a block
constexpr int kBlockN = 128;                  // keys of a K/V tile
constexpr int kStages = 3;
constexpr int kThreads = 128 * kConsumers;

struct Barriers {
  uint64_t q;                // the Q tile has landed
  uint64_t k[kStages];       // K tile of the stage has landed
  uint64_t v[kStages];       // V tile of the stage has landed
  uint64_t empty[kStages];   // every consumer thread is done with the stage
};

// Shared memory of the head_dim-kD kernel: tiles of kD / 64 halves of 64
// columns.
template <int kD>
struct Smem {
  static constexpr int kHalves = kD / 64;
  static constexpr int kQWGBytes = kRowsWG * kD * 2;   // a warpgroup's Q rows
  static constexpr int kQHalf = kRowsWG * 64 * 2;      // 8 KB: [64][64]
  static constexpr int kKVBytes = kBlockN * kD * 2;    // a K or V tile
  static constexpr int kKVHalf = kBlockN * 64 * 2;     // 16 KB: [128][64]
  static constexpr int kOffQ = 0;
  static constexpr int kOffK = kOffQ + kConsumers * kQWGBytes;
  static constexpr int kOffV = kOffK + kStages * kKVBytes;
  static constexpr int kOffBar = kOffV + kStages * kKVBytes;
  static constexpr int kBytes = kOffBar + sizeof(Barriers) + 1024;  // + alignment slack
};

// One tile's step of the online softmax on the S accumulator (two rows a
// thread: row0 and row0 + 8): mask (only where `masked`), the new row max
// over the quad, P = exp2(s * c - m * c) in place, l += this thread's share
// of the row sum; returns the factors that rescale the old accumulator.
__device__ __forceinline__ void softmax_step(float (&sc)[64], float& m0, float& m1, float& l0,
                                             float& l1, float& alpha0, float& alpha1,
                                             bool masked, int k0, int row0, int cq, int Sk,
                                             int causal, float c) {
  if (masked) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int col = k0 + (i / 4) * 8 + cq + (i % 2);
      const int row = row0 + ((i / 2) % 2) * 8;
      if (col >= Sk || (causal && col > row)) sc[i] = -INFINITY;
    }
  }
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int i = 0; i < 64; i += 4) {
    mx0 = fmaxf(mx0, fmaxf(sc[i], sc[i + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[i + 2], sc[i + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  // A row with nothing visible yet keeps max -inf: subtract 0 instead of
  // -inf so that exp2 gives 0, not nan.
  const float ms0 = mx0 == -INFINITY ? 0.0f : mx0 * c;
  const float ms1 = mx1 == -INFINITY ? 0.0f : mx1 * c;
  alpha0 = exp2_approx(m0 * c - ms0);
  alpha1 = exp2_approx(m1 * c - ms1);
  m0 = mx0;
  m1 = mx1;
  float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
  for (int i = 0; i < 64; i += 4) {
    sc[i] = exp2_approx(fmaf(sc[i], c, -ms0));
    sc[i + 1] = exp2_approx(fmaf(sc[i + 1], c, -ms0));
    sc[i + 2] = exp2_approx(fmaf(sc[i + 2], c, -ms1));
    sc[i + 3] = exp2_approx(fmaf(sc[i + 3], c, -ms1));
    sum0 += sc[i] + sc[i + 1];
    sum1 += sc[i + 2] + sc[i + 3];
  }
  l0 = l0 * alpha0 + sum0;  // this thread's columns; the quad sums at the end
  l1 = l1 * alpha1 + sum1;
}

// acc *= alpha per row, and P (the softmaxed S accumulator) as bf16 A
// fragments: keys 16kk..16kk+15 are accumulator columns 8(2kk) and
// 8(2kk+1), i.e. sc[8kk .. 8kk+7].
template <int kAcc>
__device__ __forceinline__ void rescale_and_pack(float (&acc)[kAcc], const float (&sc)[64],
                                                 uint32_t (&pa)[32], float alpha0,
                                                 float alpha1) {
#pragma unroll
  for (int i = 0; i < kAcc; i += 4) {
    acc[i] *= alpha0;
    acc[i + 1] *= alpha0;
    acc[i + 2] *= alpha1;
    acc[i + 3] *= alpha1;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) pa[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
}

template <int kD>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap o_map,
    float* __restrict__ lse, int B, int H, int KVH, int Sq, int Sk, int causal, float scale) {
  using L = Smem<kD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  Barriers& bar = *reinterpret_cast<Barriers*>(smem + L::kOffBar);

  const int n_q = (Sq + kBlockM - 1) / kBlockM;
  const int bh = static_cast<int>(blockIdx.x) % (B * H);
  const int qt = n_q - 1 - static_cast<int>(blockIdx.x) / (B * H);  // longest first
  const int h = bh % H, b = bh / H;
  const int kvh = h / (H / KVH);
  const int q0 = qt * kBlockM;
  const int n_k = (Sk + kBlockN - 1) / kBlockN;
  // Causal: K tiles past the block's last row are invisible to every row.
  const int k_end = causal ? min(n_k, (q0 + kBlockM + kBlockN - 1) / kBlockN) : n_k;

  // Thread 0 loads: Q once, then each K/V tile one tile ahead of its use,
  // into the stage whose previous tile both warpgroups have released.
  const CUtensorMap* k_tma = &k_map;
  const CUtensorMap* v_tma = &v_map;
  auto load_kv = [&](int j) {
    const int s = j % kStages;
    if (j >= kStages) mbar_wait(&bar.empty[s], (j / kStages - 1) & 1);
    mbar_arrive_expect_tx(&bar.k[s], L::kKVBytes);
    for (int half = 0; half < L::kHalves; ++half)
      tma_load_4d(smem + L::kOffK + s * L::kKVBytes + half * L::kKVHalf, k_tma, &bar.k[s],
                  half * 64, kvh, j * kBlockN, b);
    mbar_arrive_expect_tx(&bar.v[s], L::kKVBytes);
    for (int half = 0; half < L::kHalves; ++half)
      tma_load_4d(smem + L::kOffV + s * L::kKVBytes + half * L::kKVHalf, v_tma, &bar.v[s],
                  half * 64, kvh, j * kBlockN, b);
  };
  if (threadIdx.x == 0) {
    mbar_init(&bar.q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bar.k[s], 1);
      mbar_init(&bar.v[s], 1);
      mbar_init(&bar.empty[s], kThreads);
    }
    fence_barrier_init();
    mbar_arrive_expect_tx(&bar.q, kConsumers * L::kQWGBytes);
    for (int w = 0; w < kConsumers; ++w)
      for (int half = 0; half < L::kHalves; ++half)
        tma_load_4d(smem + L::kOffQ + w * L::kQWGBytes + half * L::kQHalf, &q_map, &bar.q,
                    half * 64, h, q0 + w * kRowsWG, b);
    load_kv(0);
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int rq = lane / 4, cq = 2 * (lane % 4);
  const int row0 = q0 + wg * kRowsWG + warp * 16 + rq;  // rows row0 and row0 + 8
  const float c = scale * kLog2e;
  unsigned char* q_tile = smem + L::kOffQ + wg * L::kQWGBytes;
  const uint32_t q_addr = smem_u32(q_tile);

  constexpr int kAcc = kD / 2;  // O accumulators a thread
  float acc[kAcc], sc[64];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 64; ++i) sc[i] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
  mbar_wait(&bar.q, 0);

  for (int j = 0; j < k_end; ++j) {
    if (threadIdx.x == 0 && j + 1 < k_end) load_kv(j + 1);
    const int s = j % kStages;
    const uint32_t phase = (j / kStages) & 1;
    const uint32_t k_addr = smem_u32(smem + L::kOffK + s * L::kKVBytes);
    const uint32_t v_addr = smem_u32(smem + L::kOffV + s * L::kKVBytes);
    mbar_wait(&bar.k[s], phase);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_m64n128k16_ss(sc, kmajor_desc(q_addr + (kk / 4) * L::kQHalf + (kk % 4) * 32),
                          kmajor_desc(k_addr + (kk / 4) * L::kKVHalf + (kk % 4) * 32), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    const int k0 = j * kBlockN;
    float alpha0, alpha1;
    const bool masked = (causal && k0 + kBlockN - 1 > q0) || k0 + kBlockN > Sk;
    softmax_step(sc, m0, m1, l0, l1, alpha0, alpha1, masked, k0, row0, cq, Sk, causal, c);
    uint32_t pa[32];
    rescale_and_pack(acc, sc, pa, alpha0, alpha1);
    mbar_wait(&bar.v[s], phase);
    fence_regs(acc);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk)
      wgmma_rs_tb(acc, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                  mnmajor_desc(v_addr + kk * 2048, L::kKVHalf));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);
    mbar_arrive(&bar.empty[s]);
  }

  // Epilogue: o = acc / l as bf16 into this warpgroup's Q rows (read by
  // no one else, and done with), in the swizzled layout the TMA store reads.
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.0f / (l0 == 0.0f ? 1.0f : l0);
  const float inv1 = 1.0f / (l1 == 0.0f ? 1.0f : l1);
#pragma unroll
  for (int i = 0; i < kAcc; i += 2) {
    const int hi = (i / 2) % 2;
    const int r = warp * 16 + rq + hi * 8;
    const int col = (i / 4) * 8 + cq;
    const float inv = hi ? inv1 : inv0;
    const int chunk = ((col % 64) / 8) ^ (r % 8);
    *reinterpret_cast<uint32_t*>(q_tile + (col / 64) * L::kQHalf + r * 128 +
                                 chunk * 16 + (col % 8) * 2) =
        pack_bf16(acc[i] * inv, acc[i + 1] * inv);
  }
  fence_proxy_async();
  named_barrier_sync<128>(1 + wg);
  if (tid == 0) {
    for (int half = 0; half < L::kHalves; ++half)
      tma_store_4d(&o_map, q_tile + half * L::kQHalf, half * 64, h, q0 + wg * kRowsWG, b);
    tma_store_wait();
  }
  if (lane % 4 == 0) {
    float* out = lse + (static_cast<long long>(b) * H + h) * Sq;
    if (row0 < Sq) out[row0] = m0 * scale + logf(l0 == 0.0f ? 1.0f : l0);
    if (row0 + 8 < Sq) out[row0 + 8] = m1 * scale + logf(l1 == 0.0f ? 1.0f : l1);
  }
}

template <int kD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                   int H, int KVH, int Sq, int Sk, int causal, float scale, void* stream) {
  constexpr int kSmemBytes = Smem<kD>::kBytes;
  CUtensorMap q_map, k_map, v_map, o_map;
  cudaError_t err = make_bshd_map(&q_map, q, B, Sq, H, kD, kRowsWG);
  if (err == cudaSuccess) err = make_bshd_map(&k_map, k, B, Sk, KVH, kD, kBlockN);
  if (err == cudaSuccess) err = make_bshd_map(&v_map, v, B, Sk, KVH, kD, kBlockN);
  if (err == cudaSuccess) err = make_bshd_map(&o_map, o, B, Sq, H, kD, kRowsWG);
  if (err == cudaSuccess) err = allow_smem(flash_fwd_kernel<kD>, kSmemBytes);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>((Sq + kBlockM - 1) / kBlockM) * B * H;
  flash_fwd_kernel<kD><<<blocks, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      q_map, k_map, v_map, o_map, static_cast<float*>(lse), B, H, KVH, Sq, Sk, causal, scale);
  return cudaSuccess;
}

}  // namespace

extern "C" int tk_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                            int B, int H, int KVH, int Sq, int Sk, int D, int causal,
                            float scale, void* stream) {
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 64) err = launch<64>(q, k, v, o, lse, B, H, KVH, Sq, Sk, causal, scale, stream);
  if (D == 128) err = launch<128>(q, k, v, o, lse, B, H, KVH, Sq, Sk, causal, scale, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  TK_RETURN_LAST_ERROR();
}
