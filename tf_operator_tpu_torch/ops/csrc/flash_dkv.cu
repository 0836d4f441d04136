// Flash attention backward, the dK/dV half of the FlashAttention-2 split,
// BSHD in and out.
//
// Replaces: tf_operator_tpu/ops/flash_pallas.py:_dkv_kernel (launched by
// _flash_backward).
//
// Recomputes P = exp(scale * Q K^T - lse) from the forward's per-row
// logsumexp (no stored s x s matrix), with dP = dO V^T and
// dS = P * (dP - delta), where delta = rowsum(dO * O) - dlse is computed by
// the caller in plain torch; dV = sum P^T dO and dK = scale * sum dS^T Q,
// summed over the query heads of each KV head's group. P and dS are cast to
// bf16 before their products; every sum is fp32.
//
// Bound on the H100: operations. At llama-400m (bs 8, seq 2048, 8 heads x
// 128, causal) it does 4 products, 137.5 GFLOP; at bert-base (bs 16, seq
// 512, 12 heads x 64, non-causal) 25.8 GFLOP against 76.3 MB.
//
// Design (sm_90a, the building blocks in hopper.cuh). One kernel for each
// head_dim, 64 and 128 (the template argument kD). One block per (128
// keys, KV head, batch), two warpgroups of 64 key rows each, in the
// transposed frame so that each warpgroup owns its key rows end to end.
// - Thread 0 loads the block's K and V tiles once. Then warp 0 streams, for
//   every query head of the group and every Q tile of 64 rows from the
//   diagonal on, the Q and dO tiles by TMA and the tile's 64 lse and delta
//   values by cp.async into a 3-stage ring, a tile ahead of its use, each
//   stage completing on an mbarrier. The GQA sum therefore stays inside the
//   block, with no atomics and no second pass.
// - S^T = K Q^T and dP^T = V dO^T are wgmma m64n64k16 with both operands
//   K-major from the swizzled tiles. P^T = exp2(S^T * scale * log2 e - lse
//   * log2 e) and dS^T = P^T (dP^T - delta) run on the accumulator
//   registers, lse and delta broadcast per column (query).
// - dV += P^T dO and dK += dS^T Q are wgmma m64n128k16 (m64n64k16 at
//   head_dim 64) with A from registers (P^T and dS^T cast to bf16 pairs)
//   and B the same dO and Q tiles read MN-major. dK and dV (64 + 64 fp32 a
//   thread, 32 + 32 at head_dim 64) stay in registers: with 256
//   threads a block may use 255 registers a thread, and this kernel needs
//   about 230. (With a third, producer warpgroup the compiler held every
//   thread to 168 and spilled; setmaxnreg did not lift that.)
// - Causal: Q tiles before the diagonal are never loaded, a warpgroup whose
//   keys all come after a tile's queries skips it, only tiles that cross
//   the diagonal (or the ragged end of the queries) are masked, and the
//   blocks with the most Q tiles launch first.
// - Epilogue: dK * scale and dV to bf16, staged in the warpgroup's own K
//   and V rows and written by TMA store (rows past the end are not
//   written).
// Shared memory 163 KB at head_dim 128 (82 KB at 64): one block an SM.

#include "hopper.cuh"


namespace {

using namespace hopper;

constexpr int kRowsWG = 64;                    // key rows of a consumer warpgroup
constexpr int kConsumers = 2;                  // consumer warpgroups
constexpr int kBlockN = kRowsWG * kConsumers;  // keys of a block
constexpr int kBlockM = 64;                    // queries of a Q tile
constexpr int kStages = 3;
constexpr int kLead = kStages - 2;  // Q tiles loaded ahead of the one in use
constexpr int kThreads = 128 * kConsumers;

struct Barriers {
  uint64_t kv;               // the K and V tiles have landed
  uint64_t full[kStages];    // Q, dO, lse and delta of the stage are in
  uint64_t empty[kStages];   // every consumer thread is done with the stage
};

// Shared memory of the head_dim-kD kernel: tiles of kD / 64 halves of 64
// columns.
template <int kD>
struct Smem {
  static constexpr int kHalves = kD / 64;
  static constexpr int kWGBytes = kRowsWG * kD * 2;   // a warpgroup's K or V rows
  static constexpr int kWGHalf = kRowsWG * 64 * 2;    // 8 KB: [64][64]
  static constexpr int kQBytes = kBlockM * kD * 2;    // a Q or dO tile
  static constexpr int kQHalf = kBlockM * 64 * 2;     // 8 KB
  static constexpr int kOffK = 0;
  static constexpr int kOffV = kOffK + kConsumers * kWGBytes;
  static constexpr int kOffQ = kOffV + kConsumers * kWGBytes;
  static constexpr int kOffDO = kOffQ + kStages * kQBytes;
  static constexpr int kOffRows = kOffDO + kStages * kQBytes;  // [stage][lse 64, delta 64] fp32
  static constexpr int kOffBar = kOffRows + kStages * 2 * kBlockM * 4;
  static constexpr int kBytes = kOffBar + sizeof(Barriers) + 1024;  // + alignment slack
};

template <int kD>
__global__ void __launch_bounds__(kThreads, 1) flash_dkv_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
    const __grid_constant__ CUtensorMap dk_map, const __grid_constant__ CUtensorMap dv_map,
    const float* __restrict__ lse, const float* __restrict__ delta, int B, int H, int KVH,
    int Sq, int Sk, int causal, float scale) {
  using L = Smem<kD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  Barriers& bar = *reinterpret_cast<Barriers*>(smem + L::kOffBar);
  float* rows = reinterpret_cast<float*>(smem + L::kOffRows);

  const int bkv = static_cast<int>(blockIdx.x) % (B * KVH);
  const int kt = static_cast<int>(blockIdx.x) / (B * KVH);  // K tile 0 has the most work
  const int kvh = bkv % KVH, b = bkv / KVH;
  const int groups = H / KVH;
  const int k0 = kt * kBlockN;
  const int n_q = (Sq + kBlockM - 1) / kBlockM;
  // Causal: Q tiles before the diagonal see none of this K tile.
  const int q_begin = causal ? k0 / kBlockM : 0;
  const int n_iter = groups * (n_q - q_begin);

  // Warp 0 loads, kLead Q tiles ahead of the one in use, into the stage
  // whose previous tile both warpgroups released an iteration ago: lane 0
  // the Q and dO tiles by TMA, the 32 lanes the 64 lse and delta values by
  // cp.async (zero for padding queries, which are masked), all completing
  // on the stage's barrier.
  const CUtensorMap* q_tma = &q_map;
  const CUtensorMap* do_tma = &do_map;
  auto load_q = [&](int it) {
    const int s = it % kStages;
    const int h = kvh * groups + it / (n_q - q_begin);
    const int q0 = (q_begin + it % (n_q - q_begin)) * kBlockM;
    const int lane = threadIdx.x % 32;
    if (it >= kStages) mbar_wait(&bar.empty[s], (it / kStages - 1) & 1);
    if (lane == 0) {
      mbar_expect_tx(&bar.full[s], 2 * L::kQBytes);
      for (int half = 0; half < L::kHalves; ++half) {
        tma_load_4d(smem + L::kOffQ + s * L::kQBytes + half * L::kQHalf, q_tma, &bar.full[s],
                    half * 64, h, q0, b);
        tma_load_4d(smem + L::kOffDO + s * L::kQBytes + half * L::kQHalf, do_tma, &bar.full[s],
                    half * 64, h, q0, b);
      }
    }
    const long long base = (static_cast<long long>(b) * H + h) * Sq;
    float* dst = rows + s * 2 * kBlockM;
    for (int r = lane; r < kBlockM; r += 32) {
      const bool in = q0 + r < Sq;
      const long long at = in ? base + q0 + r : base;
      cp_async_4(dst + r, lse + at, in);
      cp_async_4(dst + kBlockM + r, delta + at, in);
    }
    cp_async_arrive(&bar.full[s]);
  };
  if (threadIdx.x == 0) {
    mbar_init(&bar.kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bar.full[s], 32);
      mbar_init(&bar.empty[s], kThreads);
    }
    fence_barrier_init();
    mbar_arrive_expect_tx(&bar.kv, 2 * kConsumers * L::kWGBytes);
    for (int w = 0; w < kConsumers; ++w)
      for (int half = 0; half < L::kHalves; ++half) {
        tma_load_4d(smem + L::kOffK + w * L::kWGBytes + half * L::kWGHalf, &k_map, &bar.kv,
                    half * 64, kvh, k0 + w * kRowsWG, b);
        tma_load_4d(smem + L::kOffV + w * L::kWGBytes + half * L::kWGHalf, &v_map, &bar.kv,
                    half * 64, kvh, k0 + w * kRowsWG, b);
      }
  }
  __syncthreads();
  if (threadIdx.x < 32)
    for (int it = 0; it < kLead && it < n_iter; ++it) load_q(it);

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int rq = lane / 4, cq = 2 * (lane % 4);
  const int kw0 = k0 + wg * kRowsWG;          // first key of this warpgroup
  const int key0 = kw0 + warp * 16 + rq;      // this thread's keys: key0 and key0 + 8
  const float c = scale * kLog2e;
  unsigned char* k_tile = smem + L::kOffK + wg * L::kWGBytes;
  unsigned char* v_tile = smem + L::kOffV + wg * L::kWGBytes;
  const uint32_t k_addr = smem_u32(k_tile), v_addr = smem_u32(v_tile);

  constexpr int kAcc = kD / 2;  // dK and dV accumulators a thread, each
  float dk[kAcc], dv[kAcc], st[32], dp[32];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) dk[i] = dv[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) st[i] = dp[i] = 0.0f;
  mbar_wait(&bar.kv, 0);

  for (int it = 0; it < n_iter; ++it) {
    if (threadIdx.x < 32 && it + kLead < n_iter) load_q(it + kLead);
    const int s = it % kStages;
    const int q0 = (q_begin + it % (n_q - q_begin)) * kBlockM;
    mbar_wait(&bar.full[s], (it / kStages) & 1);
    if (causal && q0 + kBlockM <= kw0) {  // every query before every key
      mbar_arrive(&bar.empty[s]);
      continue;
    }
    const uint32_t q_addr = smem_u32(smem + L::kOffQ + s * L::kQBytes);
    const uint32_t do_addr = smem_u32(smem + L::kOffDO + s * L::kQBytes);
    const float* lse_s = rows + s * 2 * kBlockM;
    const float* dl = lse_s + kBlockM;

    // S^T = K Q^T and dP^T = V dO^T over head_dim, two commit groups.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_m64n64k16_ss(st, kmajor_desc(k_addr + (kk / 4) * L::kWGHalf + (kk % 4) * 32),
                         kmajor_desc(q_addr + (kk / 4) * L::kQHalf + (kk % 4) * 32), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_m64n64k16_ss(dp, kmajor_desc(v_addr + (kk / 4) * L::kWGHalf + (kk % 4) * 32),
                         kmajor_desc(do_addr + (kk / 4) * L::kQHalf + (kk % 4) * 32), kk);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(st);

    // P^T on the registers; column (query) i of the thread: 8(i/4) + cq + i%2.
    const bool mask = (causal && q0 < kw0 + kRowsWG - 1) || q0 + kBlockM > Sq;
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int col = (i / 4) * 8 + cq;
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + col);
      st[i] = exp2_approx(fmaf(st[i], c, -l2.x * kLog2e));
      st[i + 1] = exp2_approx(fmaf(st[i + 1], c, -l2.y * kLog2e));
      if (mask) {
        const int key = key0 + ((i / 2) % 2) * 8;
        const int qi = q0 + col;
        if (qi >= Sq || (causal && qi < key)) st[i] = 0.0f;
        if (qi + 1 >= Sq || (causal && qi + 1 < key)) st[i + 1] = 0.0f;
      }
    }
    // dS^T = P^T (dP^T - delta); P^T and dS^T to bf16 A fragments as
    // they are made, so that the fp32 values die as the pairs are packed.
    wgmma_wait<0>();
    fence_regs(dp);
    uint32_t pa[16], da[16];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const float2 d2 = *reinterpret_cast<const float2*>(dl + (i / 4) * 8 + cq);
      pa[i / 2] = pack_bf16(st[i], st[i + 1]);
      da[i / 2] = pack_bf16(st[i] * (dp[i] - d2.x), st[i + 1] * (dp[i + 1] - d2.y));
    }
    // dV += P^T dO and dK += dS^T Q: 4 k16 steps of 16 rows (2 KB) each,
    // dO and Q read MN-major.
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pa);
    fence_regs(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockM / 16; ++kk)
      wgmma_rs_tb(dv, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                  mnmajor_desc(do_addr + kk * 2048, L::kQHalf));
#pragma unroll
    for (int kk = 0; kk < kBlockM / 16; ++kk)
      wgmma_rs_tb(dk, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2], da[4 * kk + 3],
                  mnmajor_desc(q_addr + kk * 2048, L::kQHalf));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pa);
    fence_regs(da);
    mbar_arrive(&bar.empty[s]);
  }

  // Epilogue: dK * scale and dV as bf16 into this warpgroup's own K and V
  // rows (read by no one else, and done with), in the swizzled layout the
  // TMA store reads.
#pragma unroll
  for (int i = 0; i < kAcc; i += 2) {
    const int r = warp * 16 + rq + ((i / 2) % 2) * 8;
    const int col = (i / 4) * 8 + cq;
    const int off = (col / 64) * L::kWGHalf + r * 128 + ((((col % 64) / 8) ^ (r % 8)) * 16) +
                    (col % 8) * 2;
    *reinterpret_cast<uint32_t*>(k_tile + off) = pack_bf16(dk[i] * scale, dk[i + 1] * scale);
    *reinterpret_cast<uint32_t*>(v_tile + off) = pack_bf16(dv[i], dv[i + 1]);
  }
  fence_proxy_async();
  named_barrier_sync<128>(1 + wg);
  if (tid == 0) {
    for (int half = 0; half < L::kHalves; ++half) {
      tma_store_4d(&dk_map, k_tile + half * L::kWGHalf, half * 64, kvh, kw0, b);
      tma_store_4d(&dv_map, v_tile + half * L::kWGHalf, half * 64, kvh, kw0, b);
    }
    tma_store_wait();
  }
}

template <int kD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dk, void* dv, int B, int H,
                   int KVH, int Sq, int Sk, int causal, float scale, void* stream) {
  constexpr int kSmemBytes = Smem<kD>::kBytes;
  CUtensorMap q_map, k_map, v_map, do_map, dk_map, dv_map;
  cudaError_t err = make_bshd_map(&q_map, q, B, Sq, H, kD, kBlockM);
  if (err == cudaSuccess) err = make_bshd_map(&do_map, dout, B, Sq, H, kD, kBlockM);
  if (err == cudaSuccess) err = make_bshd_map(&k_map, k, B, Sk, KVH, kD, kRowsWG);
  if (err == cudaSuccess) err = make_bshd_map(&v_map, v, B, Sk, KVH, kD, kRowsWG);
  if (err == cudaSuccess) err = make_bshd_map(&dk_map, dk, B, Sk, KVH, kD, kRowsWG);
  if (err == cudaSuccess) err = make_bshd_map(&dv_map, dv, B, Sk, KVH, kD, kRowsWG);
  if (err == cudaSuccess) err = allow_smem(flash_dkv_kernel<kD>, kSmemBytes);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>((Sk + kBlockN - 1) / kBlockN) * B * KVH;
  flash_dkv_kernel<kD><<<blocks, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      q_map, k_map, v_map, do_map, dk_map, dv_map, static_cast<const float*>(lse),
      static_cast<const float*>(delta), B, H, KVH, Sq, Sk, causal, scale);
  return cudaSuccess;
}

}  // namespace

extern "C" int tk_flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dk, void* dv, int B,
                            int H, int KVH, int Sq, int Sk, int D, int causal, float scale,
                            void* stream) {
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 64)
    err = launch<64>(q, k, v, dout, lse, delta, dk, dv, B, H, KVH, Sq, Sk, causal, scale,
                     stream);
  if (D == 128)
    err = launch<128>(q, k, v, dout, lse, delta, dk, dv, B, H, KVH, Sq, Sk, causal, scale,
                      stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  TK_RETURN_LAST_ERROR();
}
