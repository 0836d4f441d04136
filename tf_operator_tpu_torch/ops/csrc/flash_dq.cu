// Flash attention backward, the dQ half of the FlashAttention-2 split (the
// dK/dV half is flash_dkv.cu), BSHD in and out.
//
// Replaces: tf_operator_tpu/ops/flash_pallas.py:_dq_kernel (launched by
// _flash_backward).
//
// Recomputes P = exp(scale * Q K^T - lse) from the forward's per-row
// logsumexp (no stored s x s matrix), with dP = dO V^T and
// dS = P * (dP - delta), where delta = rowsum(dO * O) - dlse is computed by
// the caller in plain torch; dQ = scale * sum dS K. dS is cast to bf16
// before its product; every sum is fp32.
//
// Bound on the H100: operations. At llama-400m (bs 8, seq 2048, 8 heads x
// 128, causal) it does 3 products, 103.1 GFLOP; at bert-base (bs 16, seq
// 512, 12 heads x 64, non-causal) 19.3 GFLOP against 63.7 MB.
//
// Design (sm_90a, the building blocks in hopper.cuh): the dK/dV kernel's,
// mirrored. One kernel for each head_dim, 64 and 128 (the template
// argument kD). One block per (128 Q rows, q head, batch), two warpgroups of 64
// Q rows each, and no producer warpgroup (a third warpgroup caps ptxas at
// 168 registers a thread, which spills; flash_dkv.cu).
// - Thread 0 loads the block's Q and dO tiles once by TMA, then streams the
//   K and V tiles (128 keys each) into a 2-stage ring, one tile ahead of
//   their use; each stage completes on a `full` mbarrier and is freed
//   through an `empty` one that all 256 threads arrive on. Each thread keeps
//   its two rows' lse and delta in registers.
// - S = Q K^T and dP = dO V^T are wgmma m64n128k16 with both operands
//   K-major from the swizzled tiles, in two commit groups. P = exp2(S *
//   scale * log2 e - lse * log2 e) and dS = P (dP - delta) run on the
//   accumulator registers; dS is packed to bf16 A fragments as it is made.
// - dQ += dS K is wgmma m64n128k16 (m64n64k16 at head_dim 64) with A = dS
//   from registers and B the same K tile read MN-major. dQ (64 fp32 a
//   thread, 32 at head_dim 64) stays in registers beside S and dP (64
//   each), with no spill.
// - Tiles of 128 keys halve the barrier waits and double the work per wait
//   against 64-key tiles (which fit a 3-stage ring, and ran 13% slower;
//   PERF.md), at the price of a diagonal tile whose first warpgroup sees a
//   quarter of its pairs.
// - Causal: K tiles past the block's last row are never loaded, a
//   warpgroup whose rows all precede a tile's keys skips it, only tiles that
//   cross the diagonal (or the ragged end of the keys) are masked, and the
//   blocks with the most K tiles launch first.
// - Epilogue: dQ * scale to bf16, staged in the warpgroup's own Q rows and
//   written by TMA store (rows past the end are not written).
// Shared memory 193 KB at head_dim 128 (97 KB at 64, which keeps the
// 2-stage ring): one block an SM. GQA by index (K/V at head
// h / groups), no copies of K/V.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kRowsWG = 64;                    // Q rows of a consumer warpgroup
constexpr int kConsumers = 2;                  // consumer warpgroups
constexpr int kBlockM = kRowsWG * kConsumers;  // Q rows of a block
constexpr int kBlockN = 128;                   // keys of a K/V tile
constexpr int kStages = 2;                     // as many as fit beside Q and dO
constexpr int kThreads = 128 * kConsumers;

struct Barriers {
  uint64_t q;                // the Q and dO tiles have landed
  uint64_t full[kStages];    // the K and V tiles of the stage have landed
  uint64_t empty[kStages];   // every consumer thread is done with the stage
};

// Shared memory of the head_dim-kD kernel: tiles of kD / 64 halves of 64
// columns.
template <int kD>
struct Smem {
  static constexpr int kHalves = kD / 64;
  static constexpr int kWGBytes = kRowsWG * kD * 2;   // a warpgroup's Q or dO rows
  static constexpr int kWGHalf = kRowsWG * 64 * 2;    // 8 KB: [64][64]
  static constexpr int kKVBytes = kBlockN * kD * 2;   // a K or V tile
  static constexpr int kKVHalf = kBlockN * 64 * 2;    // 16 KB: [128][64]
  static constexpr int kOffQ = 0;
  static constexpr int kOffDO = kOffQ + kConsumers * kWGBytes;
  static constexpr int kOffK = kOffDO + kConsumers * kWGBytes;
  static constexpr int kOffV = kOffK + kStages * kKVBytes;
  static constexpr int kOffBar = kOffV + kStages * kKVBytes;
  static constexpr int kBytes = kOffBar + sizeof(Barriers) + 1024;  // + alignment slack
};

template <int kD>
__global__ void __launch_bounds__(kThreads, 1) flash_dq_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
    const __grid_constant__ CUtensorMap dq_map, const float* __restrict__ lse,
    const float* __restrict__ delta, int B, int H, int KVH, int Sq, int Sk, int causal,
    float scale) {
  using L = Smem<kD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  Barriers& bar = *reinterpret_cast<Barriers*>(smem + L::kOffBar);

  const int n_q = (Sq + kBlockM - 1) / kBlockM;
  const int bh = static_cast<int>(blockIdx.x) % (B * H);
  const int qt = n_q - 1 - static_cast<int>(blockIdx.x) / (B * H);  // most K tiles first
  const int h = bh % H, b = bh / H;
  const int kvh = h / (H / KVH);
  const int q0 = qt * kBlockM;
  const int n_k = (Sk + kBlockN - 1) / kBlockN;
  // Causal: K tiles past the block's last row are invisible to every row.
  const int k_end = causal ? min(n_k, (q0 + kBlockM + kBlockN - 1) / kBlockN) : n_k;

  // Thread 0 loads: Q and dO once, then each K/V tile one tile ahead of its
  // use, into the stage whose previous tile both warpgroups have released.
  const CUtensorMap* k_tma = &k_map;
  const CUtensorMap* v_tma = &v_map;
  auto load_kv = [&](int j) {
    const int s = j % kStages;
    if (j >= kStages) mbar_wait(&bar.empty[s], (j / kStages - 1) & 1);
    mbar_arrive_expect_tx(&bar.full[s], 2 * L::kKVBytes);
    for (int half = 0; half < L::kHalves; ++half) {
      tma_load_4d(smem + L::kOffK + s * L::kKVBytes + half * L::kKVHalf, k_tma, &bar.full[s],
                  half * 64, kvh, j * kBlockN, b);
      tma_load_4d(smem + L::kOffV + s * L::kKVBytes + half * L::kKVHalf, v_tma, &bar.full[s],
                  half * 64, kvh, j * kBlockN, b);
    }
  };
  if (threadIdx.x == 0) {
    mbar_init(&bar.q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bar.full[s], 1);
      mbar_init(&bar.empty[s], kThreads);
    }
    fence_barrier_init();
    mbar_arrive_expect_tx(&bar.q, 2 * kConsumers * L::kWGBytes);
    for (int w = 0; w < kConsumers; ++w)
      for (int half = 0; half < L::kHalves; ++half) {
        tma_load_4d(smem + L::kOffQ + w * L::kWGBytes + half * L::kWGHalf, &q_map, &bar.q,
                    half * 64, h, q0 + w * kRowsWG, b);
        tma_load_4d(smem + L::kOffDO + w * L::kWGBytes + half * L::kWGHalf, &do_map, &bar.q,
                    half * 64, h, q0 + w * kRowsWG, b);
      }
    load_kv(0);
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int rq = lane / 4, cq = 2 * (lane % 4);
  const int qw0 = q0 + wg * kRowsWG;        // first row of this warpgroup
  const int row0 = qw0 + warp * 16 + rq;    // this thread's rows: row0 and row0 + 8
  const float c = scale * kLog2e;
  unsigned char* q_tile = smem + L::kOffQ + wg * L::kWGBytes;
  const uint32_t q_addr = smem_u32(q_tile);
  const uint32_t do_addr = smem_u32(smem + L::kOffDO + wg * L::kWGBytes);

  // lse * log2 e and delta of the thread's two rows, 0 for rows past the
  // end (their Q and dO rows are zero, so their dS is 0, and their dQ is
  // never stored).
  const long long rows = (static_cast<long long>(b) * H + h) * Sq;
  const float ls0 = row0 < Sq ? lse[rows + row0] * kLog2e : 0.0f;
  const float ls1 = row0 + 8 < Sq ? lse[rows + row0 + 8] * kLog2e : 0.0f;
  const float dl0 = row0 < Sq ? delta[rows + row0] : 0.0f;
  const float dl1 = row0 + 8 < Sq ? delta[rows + row0 + 8] : 0.0f;

  constexpr int kAcc = kBlockN / 2;  // S and dP accumulators a thread
  constexpr int kDQ = kD / 2;        // dQ accumulators a thread
  float dq[kDQ], st[kAcc], dp[kAcc];
#pragma unroll
  for (int i = 0; i < kDQ; ++i) dq[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < kAcc; ++i) st[i] = dp[i] = 0.0f;
  mbar_wait(&bar.q, 0);

  for (int j = 0; j < k_end; ++j) {
    if (threadIdx.x == 0 && j + 1 < k_end) load_kv(j + 1);
    const int s = j % kStages;
    const int k0 = j * kBlockN;
    mbar_wait(&bar.full[s], (j / kStages) & 1);
    if (causal && k0 > qw0 + kRowsWG - 1) {  // every key after every row
      mbar_arrive(&bar.empty[s]);
      continue;
    }
    const uint32_t k_addr = smem_u32(smem + L::kOffK + s * L::kKVBytes);
    const uint32_t v_addr = smem_u32(smem + L::kOffV + s * L::kKVBytes);

    // S = Q K^T and dP = dO V^T over head_dim, two commit groups.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_m64n128k16_ss(st, kmajor_desc(q_addr + (kk / 4) * L::kWGHalf + (kk % 4) * 32),
                          kmajor_desc(k_addr + (kk / 4) * L::kKVHalf + (kk % 4) * 32), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_m64n128k16_ss(dp, kmajor_desc(do_addr + (kk / 4) * L::kWGHalf + (kk % 4) * 32),
                          kmajor_desc(v_addr + (kk / 4) * L::kKVHalf + (kk % 4) * 32), kk);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(st);

    // P on the registers: st[i] is row row0 + 8((i/2)%2), key
    // k0 + 8(i/4) + cq + i%2.
    const bool mask = (causal && k0 + kBlockN - 1 > qw0) || k0 + kBlockN > Sk;
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int hi = (i / 2) % 2;
      st[i] = exp2_approx(fmaf(st[i], c, -(hi ? ls1 : ls0)));
      if (mask) {
        const int key = k0 + (i / 4) * 8 + cq + i % 2;
        if (key >= Sk || (causal && key > row0 + 8 * hi)) st[i] = 0.0f;
      }
    }
    // dS = P (dP - delta), to bf16 A fragments as it is made: keys
    // 16kk..16kk+15 are st[8kk .. 8kk+7], i.e. da[4kk .. 4kk+3].
    wgmma_wait<0>();
    fence_regs(dp);
    uint32_t da[kAcc / 2];
#pragma unroll
    for (int i = 0; i < kAcc; i += 2) {
      const float dl = (i / 2) % 2 ? dl1 : dl0;
      da[i / 2] = pack_bf16(st[i] * (dp[i] - dl), st[i + 1] * (dp[i + 1] - dl));
    }
    // dQ += dS K: k16 steps of 16 keys (2 KB) each, K read MN-major.
    fence_regs(dq);
    fence_regs(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk)
      wgmma_rs_tb(dq, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2], da[4 * kk + 3],
                  mnmajor_desc(k_addr + kk * 2048, L::kKVHalf));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(da);
    mbar_arrive(&bar.empty[s]);
  }

  // Epilogue: dQ * scale as bf16 into this warpgroup's own Q rows (read by
  // no one else, and done with), in the swizzled layout the TMA store reads.
#pragma unroll
  for (int i = 0; i < kDQ; i += 2) {
    const int r = warp * 16 + rq + ((i / 2) % 2) * 8;
    const int col = (i / 4) * 8 + cq;
    const int off = (col / 64) * L::kWGHalf + r * 128 + ((((col % 64) / 8) ^ (r % 8)) * 16) +
                    (col % 8) * 2;
    *reinterpret_cast<uint32_t*>(q_tile + off) = pack_bf16(dq[i] * scale, dq[i + 1] * scale);
  }
  fence_proxy_async();
  named_barrier_sync<128>(1 + wg);
  if (tid == 0) {
    for (int half = 0; half < L::kHalves; ++half)
      tma_store_4d(&dq_map, q_tile + half * L::kWGHalf, half * 64, h, qw0, b);
    tma_store_wait();
  }
}

template <int kD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dq, int B, int H, int KVH, int Sq,
                   int Sk, int causal, float scale, void* stream) {
  constexpr int kSmemBytes = Smem<kD>::kBytes;
  CUtensorMap q_map, k_map, v_map, do_map, dq_map;
  cudaError_t err = make_bshd_map(&q_map, q, B, Sq, H, kD, kRowsWG);
  if (err == cudaSuccess) err = make_bshd_map(&do_map, dout, B, Sq, H, kD, kRowsWG);
  if (err == cudaSuccess) err = make_bshd_map(&dq_map, dq, B, Sq, H, kD, kRowsWG);
  if (err == cudaSuccess) err = make_bshd_map(&k_map, k, B, Sk, KVH, kD, kBlockN);
  if (err == cudaSuccess) err = make_bshd_map(&v_map, v, B, Sk, KVH, kD, kBlockN);
  if (err == cudaSuccess) err = allow_smem(flash_dq_kernel<kD>, kSmemBytes);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>((Sq + kBlockM - 1) / kBlockM) * B * H;
  flash_dq_kernel<kD><<<blocks, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      q_map, k_map, v_map, do_map, dq_map, static_cast<const float*>(lse),
      static_cast<const float*>(delta), B, H, KVH, Sq, Sk, causal, scale);
  return cudaSuccess;
}

}  // namespace

extern "C" int tk_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dq, int B, int H, int KVH,
                           int Sq, int Sk, int D, int causal, float scale, void* stream) {
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 64)
    err = launch<64>(q, k, v, dout, lse, delta, dq, B, H, KVH, Sq, Sk, causal, scale, stream);
  if (D == 128)
    err = launch<128>(q, k, v, dout, lse, delta, dq, B, H, KVH, Sq, Sk, causal, scale, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  TK_RETURN_LAST_ERROR();
}
