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
// Design (sm_90a, the building blocks in hopper.cuh). Three instances,
// the template argument kD: kD = 64 serves head_dim 8..64, 128 serves
// 72..128 and 256 serves 136..256 (multiples of 8). The tensor maps carry
// the true head_dim, so TMA zero-fills the tile columns past it on every
// load and clips them on the stores of dK and dV (hopper.cuh, "Head
// dims"); lse and delta are per query, not per column. At kD 64 and 128,
// one block per (128 keys, KV head, batch), two warpgroups of 64 key rows
// each, in the transposed frame so that each warpgroup owns its key rows
// end to end. At 256 a warpgroup's dK and dV over the whole head dim
// would be 2 x 128 fp32 a thread, past the 255 registers a thread may
// have, and 128 keys of K and V take 128 KB. So a block holds 64 keys and
// its two warpgroups split the head dim instead: each computes the same
// S^T and dP^T over all 256 columns (the two score products done twice,
// 6 products' work where 4 would do) and accumulates dK and dV on its own
// 128 columns (64 + 64 fp32 a thread, as at kD 128). One launch, no
// second pass over Q and dO, and no exchange between the warpgroups;
// shared memory K 32 + V 32 + 2 stages x (Q 32 + dO 32) = 192 KB.
// - Thread 0 loads the block's K and V tiles once. Then warp 0 streams, for
//   every query head of the group and every Q tile of 64 rows from the
//   diagonal on, the Q and dO tiles by TMA and the tile's 64 lse and delta
//   values by cp.async into a ring (3 stages, 2 at kD 256), a tile ahead of
//   its use, each stage completing on an mbarrier. The GQA sum therefore stays inside the
//   block, with no atomics and no second pass.
// - S^T = K Q^T and dP^T = V dO^T are wgmma m64n64k16 with both operands
//   K-major from the swizzled tiles. P^T = exp2(S^T * scale * log2 e - lse
//   * log2 e) and dS^T = P^T (dP^T - delta) run on the accumulator
//   registers, lse and delta broadcast per column (query).
// - dV += P^T dO and dK += dS^T Q are wgmma m64n128k16 (m64n64k16 at
//   kD 64; at 256 on the warpgroup's 128 columns) with A from registers
//   (P^T and dS^T cast to bf16 pairs) and B the same dO and Q tiles read
//   MN-major. dK and dV (64 + 64 fp32 a thread, 32 + 32 at kD 64) stay in
//   registers: with 256
//   threads a block may use 255 registers a thread, and this kernel needs
//   about 230. (With a third, producer warpgroup the compiler held every
//   thread to 168 and spilled; setmaxnreg did not lift that.)
// - Causal: Q tiles before the diagonal are never loaded, a warpgroup whose
//   keys all come after a tile's queries skips it, only tiles that cross
//   the diagonal (or the ragged end of the queries) are masked, and the
//   blocks with the most Q tiles launch first.
// - Epilogue: dK * scale and dV to bf16, staged in the warpgroup's own K
//   and V rows (at kD 256, its own columns of the block's K and V rows,
//   once both warpgroups are done with them) and written by TMA store
//   (rows past the end and columns past the head dim are not written).
// Shared memory 163 KB at kD 128, 82 KB at 64 and 194 KB at 256: one block
// an SM.

#include "hopper.cuh"


namespace {

using namespace hopper;

constexpr int kRowsWG = 64;                    // key rows of a consumer warpgroup
constexpr int kConsumers = 2;                  // consumer warpgroups
constexpr int kBlockM = 64;                    // queries of a Q tile
constexpr int kMaxStages = 3;
// Q tiles loaded ahead of the one in use: a load reuses the stage of the
// tile kStages - 1 before the one in use, which both warpgroups released.
constexpr int kLead = 1;
constexpr int kThreads = 128 * kConsumers;

struct Barriers {
  uint64_t kv;                  // the K and V tiles have landed
  uint64_t full[kMaxStages];    // Q, dO, lse and delta of the stage are in
  uint64_t empty[kMaxStages];   // every consumer thread is done with the stage
};

// Tiles and shared memory of the kD instance: tiles of kD / 64 halves of
// 64 columns.
template <int kD>
struct Smem {
  // At 256 the two warpgroups share the block's 64 keys and split the head
  // dim; below, each owns 64 keys over the whole head dim.
  static constexpr bool kSplitD = kD > 128;
  static constexpr int kKeyGroups = kSplitD ? 1 : kConsumers;  // 64-key groups of a block
  static constexpr int kBlockN = kRowsWG * kKeyGroups;         // keys of a block
  static constexpr int kCols = kSplitD ? kD / kConsumers : kD; // dK/dV columns a warpgroup
  static constexpr int kStages = kSplitD ? 2 : 3;
  static constexpr int kHalves = kD / 64;
  static constexpr int kWGBytes = kRowsWG * kD * 2;   // a warpgroup's K or V rows
  static constexpr int kWGHalf = kRowsWG * 64 * 2;    // 8 KB: [64][64]
  static constexpr int kQBytes = kBlockM * kD * 2;    // a Q or dO tile
  static constexpr int kQHalf = kBlockM * 64 * 2;     // 8 KB
  static constexpr int kOffK = 0;
  static constexpr int kOffV = kOffK + kKeyGroups * kWGBytes;
  static constexpr int kOffQ = kOffV + kKeyGroups * kWGBytes;
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
  constexpr int kBlockN = L::kBlockN, kStages = L::kStages;
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
    mbar_arrive_expect_tx(&bar.kv, 2 * L::kKeyGroups * L::kWGBytes);
    for (int w = 0; w < L::kKeyGroups; ++w)
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
  const int kg = L::kSplitD ? 0 : wg;        // this warpgroup's 64 keys
  const int kw0 = k0 + kg * kRowsWG;          // first key of this warpgroup
  const int key0 = kw0 + warp * 16 + rq;      // this thread's keys: key0 and key0 + 8
  const int half0 = L::kSplitD ? wg * L::kCols / 64 : 0;  // first half of its dK/dV columns
  const float c = scale * kLog2e;
  unsigned char* k_tile = smem + L::kOffK + kg * L::kWGBytes;
  unsigned char* v_tile = smem + L::kOffV + kg * L::kWGBytes;
  const uint32_t k_addr = smem_u32(k_tile), v_addr = smem_u32(v_tile);

  constexpr int kAcc = L::kCols / 2;  // dK and dV accumulators a thread, each
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
    // dV += P^T dO and dK += dS^T Q on the warpgroup's columns: 4 k16
    // steps of 16 rows (2 KB) each, dO and Q read MN-major.
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pa);
    fence_regs(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockM / 16; ++kk)
      wgmma_rs_tb(dv, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                  do_addr + half0 * L::kQHalf + kk * 2048, L::kQHalf);
#pragma unroll
    for (int kk = 0; kk < kBlockM / 16; ++kk)
      wgmma_rs_tb(dk, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2], da[4 * kk + 3],
                  q_addr + half0 * L::kQHalf + kk * 2048, L::kQHalf);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pa);
    fence_regs(da);
    mbar_arrive(&bar.empty[s]);
  }

  // Epilogue: dK * scale and dV as bf16 into this warpgroup's own K and V
  // rows (read by no one else, and done with; at kD 256 its own columns of
  // the shared rows, once the other warpgroup is done reading them), in the
  // swizzled layout the TMA store reads.
  if (L::kSplitD) __syncthreads();
#pragma unroll
  for (int i = 0; i < kAcc; i += 2) {
    const int r = warp * 16 + rq + ((i / 2) % 2) * 8;
    const int col = half0 * 64 + (i / 4) * 8 + cq;
    const int off = (col / 64) * L::kWGHalf + r * 128 + ((((col % 64) / 8) ^ (r % 8)) * 16) +
                    (col % 8) * 2;
    *reinterpret_cast<uint32_t*>(k_tile + off) = pack_bf16(dk[i] * scale, dk[i + 1] * scale);
    *reinterpret_cast<uint32_t*>(v_tile + off) = pack_bf16(dv[i], dv[i + 1]);
  }
  fence_proxy_async();
  named_barrier_sync<128>(1 + wg);
  if (tid == 0) {
    for (int half = half0; half < half0 + L::kCols / 64; ++half) {
      tma_store_4d(&dk_map, k_tile + half * L::kWGHalf, half * 64, kvh, kw0, b);
      tma_store_4d(&dv_map, v_tile + half * L::kWGHalf, half * 64, kvh, kw0, b);
    }
    tma_store_wait();
  }
}

// Launch the kD instance on tensors of head_dim D (kD / 2 < D <= kD).
template <int kD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dk, void* dv, int B, int H,
                   int KVH, int Sq, int Sk, int D, int causal, float scale, void* stream) {
  constexpr int kSmemBytes = Smem<kD>::kBytes;
  constexpr int kBlockN = Smem<kD>::kBlockN;
  CUtensorMap q_map, k_map, v_map, do_map, dk_map, dv_map;
  cudaError_t err = make_bshd_map(&q_map, q, B, Sq, H, D, kBlockM);
  if (err == cudaSuccess) err = make_bshd_map(&do_map, dout, B, Sq, H, D, kBlockM);
  if (err == cudaSuccess) err = make_bshd_map(&k_map, k, B, Sk, KVH, D, kRowsWG);
  if (err == cudaSuccess) err = make_bshd_map(&v_map, v, B, Sk, KVH, D, kRowsWG);
  if (err == cudaSuccess) err = make_bshd_map(&dk_map, dk, B, Sk, KVH, D, kRowsWG);
  if (err == cudaSuccess) err = make_bshd_map(&dv_map, dv, B, Sk, KVH, D, kRowsWG);
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
  // Head dims that are a multiple of 8 from 8 to 256 (ops/flash.py
  // refuses every other before it calls).
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
