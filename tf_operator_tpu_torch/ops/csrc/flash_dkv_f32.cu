// Flash attention backward on fp32 inputs, the dK/dV half of the
// FlashAttention-2 split (the dQ half is flash_dq_f32.cu), BSHD in and out,
// every product fp32-accurate and every sum in fp32.
//
// Replaces: tf_operator_tpu/ops/flash_pallas.py:_dkv_kernel (launched by
// _flash_backward) on fp32 inputs, where P and dS are cast to the inputs'
// dtype, fp32, before their products.
//
// Recomputes P^T = exp(scale * K Q^T - lse) a query tile at a time, with
// dP^T = V dO^T and dS^T = P^T * (dP^T - delta); dV = sum P^T dO and dK =
// scale * sum dS^T Q, summed over the query rows and over each KV head's
// group of query heads (GQA).
//
// Bound on the H100: operations. At llama-400m in fp32 (bs 8, seq 2048, 8
// heads x 128, causal) it does 4 products, 137.5 GFLOP, whose least time is
// over a third of the TF32 peak (3xTF32; device.py TF32_PASSES).
//
// Design at kD = 64 and 128 (head dims 8..64 and 72..128, multiples of 8;
// sm_90a, tf32x3.cuh for the split, the layouts and the products, hopper.cuh
// for barriers and TMA): 3xTF32 on wgmma. One block per (64 keys, KV head,
// batch), the key tiles with the most causal rows first, of two
// warpgroups:
// - the producer (warpgroup 1) loads K and V once by TMA and splits them in
//   place (hi rounded over the raw tile, lo beside it). Its warp 0 then
//   streams, for every query head of the group and every tile of kN
//   queries from the diagonal on, Q and dO by TMA and the tile's lse and
//   delta by cp.async into a ring of A slots, a tile ahead; for each tile
//   the producer splits Q and dO in place (then signals ready_a) and, once
//   all of its threads have, writes Q^T and dO^T hi and lo, from those hi
//   and lo, into a ring of T slots (then ready_t): a .tf32 operand is
//   K-major only, and dK += dS^T Q
//   and dV += P^T dO take Q and dO with the queries as K, in the order that
//   makes the consumer's accumulators the A fragments as they stand
//   (tf32x3.cuh). The GQA sum stays inside the block: no atomics, no second
//   pass.
// - the consumer (warpgroup 0) computes S^T = K Q^T and dP^T = V dO^T, each
//   three wgmma m64nNk8 passes a k8 step with both operands from shared
//   memory, reads the tile's lse and delta, frees the A slot, forms P^T =
//   exp2(S^T * scale * log2 e - lse * log2 e) and dS^T = P^T (dP^T - delta)
//   on the accumulator registers, splits both into hi and lo (cvt.rna.tf32)
//   and adds P^T dO and dS^T Q to the dV and dK accumulators in registers
//   (kD / 2 fp32 a thread each) as three register-A passes (m64n64k8 at kD
//   64, m64n128k8 at 128) over dO^T and Q^T; then frees the T slot. No
//   product runs on the CUDA cores.
// - Causal: query tiles before the block's first key are never loaded, and
//   only tiles that cross the diagonal (or the ragged end of the queries)
//   are masked.
// - Epilogue: dK * scale and dV staged in the K and V (hi) tiles and written
//   by TMA store (rows past the end and columns past the head dim are not
//   written).
// Shared memory (KB = 1024 bytes): K, K lo, V, V lo of 64 keys (K and V
// hi after the split); an A slot holds Q, dO, Q lo and dO lo, a T slot Q^T
// and dO^T hi and lo (two columns a query), each of kN queries, beside the
// slots' lse and delta:
//   kD 64:  kN 32, 64 + 2 A slots x 32 + 2 T slots x 32 = 192 KB;
//   kD 128: kN 16, 128 + 2 x 32 + 1 x 32 = 224 KB (the next tile's
//           transposes wait until this one's dV and dK products are done).
// One block an SM.
//
// kD = 256 (head dims 136..256) stays on FMAs on the CUDA cores
// (flash_f32.cuh, flash_dkv_f32_kernel_fma below): K, V and their lo parts
// for the 64 keys a warpgroup's wgmma needs take 256 KB, past the 227 KB a
// block may have, before any Q tile; streaming K and V in head-dim chunks
// would recompute or keep S^T and dP^T across the chunks, a design of its
// own (ROADMAP.md, Queue 2).

#include "flash_f32.cuh"
#include "tf32x3.cuh"

namespace cuda_cores {

using namespace f32;

// The FMA kernel, at kD 256 only: one block of 256 threads per (64 keys,
// KV head, batch); for each query head of the group and each Q/dO tile of
// 32 rows that sees a key of the block, S^T and dP^T by FMAs (4 keys x 2
// rows a thread each), P^T and dS^T in registers, P and dS written
// transposed back to shared memory, and P^T dO and dS^T Q added to the dV
// and dK accumulators (4 keys x 16 columns a thread each). Shared memory:
// K, V [64][260], Q, dO [32][260], P, dS [32][68] and the tile's lse and
// delta, in floats: 217 KB.
template <int kD>
struct Tiles {
  static constexpr int kBlockM = 32;  // query rows of a Q/dO tile
  static constexpr int kJ = kBlockM / 16;  // S^T columns a thread
  static constexpr int kBytes = (2 * kRows * stride<kD>() + 2 * kBlockM * stride<kD>() +
                                 2 * kBlockM * kTStride + 2 * kBlockM) * 4;
};

template <int kD>
__global__ void __launch_bounds__(kThreads, 1) flash_dkv_f32_kernel_fma(
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
cudaError_t launch_fma(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dk, void* dv, int B, int H,
                   int KVH, int Sq, int Sk, int D, int causal, float scale, void* stream) {
  constexpr int kBytes = Tiles<kD>::kBytes;
  const cudaError_t err = allow_smem(flash_dkv_f32_kernel_fma<kD>, kBytes);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>((Sk + kRows - 1) / kRows) * B * KVH;
  flash_dkv_f32_kernel_fma<kD><<<blocks, kThreads, kBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv), B, H,
      KVH, Sq, Sk, D, causal, scale);
  return cudaSuccess;
}

}  // namespace cuda_cores

namespace {

using namespace hopper;
using namespace tf32x3;

constexpr int kKeys = 64;       // keys of a block: the consumer warpgroup's
constexpr int kThreads = 256;   // warpgroup 0 consumes, warpgroup 1 produces
constexpr int kMaxSlots = 2;

struct Barriers {
  uint64_t kv_full;               // K and V have landed
  uint64_t kv_ready;              // K and V are split: hi in place, lo beside
  uint64_t full[kMaxSlots];       // Q, dO, lse and delta of the A slot are in
  uint64_t ready_a[kMaxSlots];    // Q and dO are split: hi in place, lo beside
  uint64_t empty_a[kMaxSlots];    // the consumer is done with the A slot
  uint64_t ready_t[kMaxSlots];    // Q^T and dO^T hi and lo are written
  uint64_t empty_t[kMaxSlots];    // the consumer is done with them
};

template <int kD>
struct Smem {
  static constexpr int kN = kD == 64 ? 32 : 16;  // queries of a tile
  static constexpr int kSlotsA = 2;
  static constexpr int kSlotsT = kD == 64 ? 2 : 1;
  static constexpr int kKV = kKeys * kD * 4;      // K, V or a lo of them
  static constexpr int kTile = kN * kD * 4;       // Q, dO or a lo of them
  static constexpr int kSlotA = 4 * kTile;        // Q, dO, Q lo, dO lo
  static constexpr int kSlotT = 4 * kTile;        // Q^T hi|lo, dO^T hi|lo
  static constexpr int kOffK = 0;                 // K, K lo, V, V lo
  static constexpr int kOffA = 4 * kKV;
  static constexpr int kOffT = kOffA + kSlotsA * kSlotA;
  static constexpr int kOffRows = kOffT + kSlotsT * kSlotT;  // [slot][lse kN, delta kN]
  static constexpr int kOffBar = kOffRows + kSlotsA * 2 * kN * 4;
  static constexpr int kBytes = kOffBar + sizeof(Barriers) + 1024;  // + alignment slack
};

template <int kD>
__global__ void __launch_bounds__(kThreads, 1) flash_dkv_f32_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
    const __grid_constant__ CUtensorMap dk_map, const __grid_constant__ CUtensorMap dv_map,
    const float* __restrict__ lse, const float* __restrict__ delta, int B, int H, int KVH,
    int Sq, int Sk, int causal, float scale) {
  using L = Smem<kD>;
  constexpr int kN = L::kN, kSA = L::kSlotsA, kST = L::kSlotsT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  Barriers& bar = *reinterpret_cast<Barriers*>(smem + L::kOffBar);
  float* rows = reinterpret_cast<float*>(smem + L::kOffRows);

  const int bkv = static_cast<int>(blockIdx.x) % (B * KVH);
  const int kt = static_cast<int>(blockIdx.x) / (B * KVH);  // K tile 0 has the most work
  const int kvh = bkv % KVH, b = bkv / KVH;
  const int groups = H / KVH;
  const int k0 = kt * kKeys;
  const int n_q = (Sq + kN - 1) / kN;
  // Causal: query tiles before the block's first key see none of its keys.
  const int q_begin = causal ? k0 / kN : 0;
  const int n_qt = n_q - q_begin;
  const int n_iter = groups * n_qt;

  if (threadIdx.x == 0) {
    mbar_init(&bar.kv_full, 1);
    mbar_init(&bar.kv_ready, 128);
    for (int s = 0; s < kMaxSlots; ++s) {
      mbar_init(&bar.full[s], 32);
      mbar_init(&bar.ready_a[s], 128);
      mbar_init(&bar.empty_a[s], 128);
      mbar_init(&bar.ready_t[s], 128);
      mbar_init(&bar.empty_t[s], 128);
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  unsigned char* k_tile = smem + L::kOffK;
  unsigned char* v_tile = smem + L::kOffK + 2 * L::kKV;

  if (wg == 1) {
    // ------------------------------------------------ producer
    // Q, dO, lse and delta of tile `it` into A slot it % kSA by the 32 lanes
    // of warp 0 (tid < 32), once the consumer is done with the slot's last
    // tile: lane 0 the tiles by TMA, every lane lse and delta by cp.async
    // (zero for padding queries, which are masked), all completing on the
    // slot's full barrier.
    const CUtensorMap* q_tma = &q_map;
    const CUtensorMap* do_tma = &do_map;
    auto issue = [&](int it) {
      const int s = it % kSA;
      const int h = kvh * groups + it / n_qt;
      const int q0 = (q_begin + it % n_qt) * kN;
      if (it >= kSA) mbar_wait(&bar.empty_a[s], (it / kSA - 1) & 1);
      unsigned char* a = smem + L::kOffA + s * L::kSlotA;
      if (tid == 0) {
        mbar_expect_tx(&bar.full[s], 2 * L::kTile);
        for (int p = 0; p < kD / 32; ++p) {
          tma_load_4d(a + p * kN * 128, q_tma, &bar.full[s], p * 32, h, q0, b);
          tma_load_4d(a + L::kTile + p * kN * 128, do_tma, &bar.full[s], p * 32, h, q0, b);
        }
      }
      const long long base = (static_cast<long long>(b) * H + h) * Sq;
      float* dst = rows + s * 2 * kN;
      for (int r = tid; r < kN; r += 32) {
        const bool in = q0 + r < Sq;
        const long long at = in ? base + q0 + r : base;
        cp_async_4(dst + r, lse + at, in);
        cp_async_4(dst + kN + r, delta + at, in);
      }
      cp_async_arrive(&bar.full[s]);
    };
    if (tid == 0) {
      mbar_arrive_expect_tx(&bar.kv_full, 2 * L::kKV);
      for (int p = 0; p < kD / 32; ++p) {
        tma_load_4d(k_tile + p * kKeys * 128, &k_map, &bar.kv_full, p * 32, kvh, k0, b);
        tma_load_4d(v_tile + p * kKeys * 128, &v_map, &bar.kv_full, p * 32, kvh, k0, b);
      }
    }
    if (tid < 32)
      for (int it = 0; it < kSA - 1 && it < n_iter; ++it) issue(it);
    mbar_wait(&bar.kv_full, 0);
    split_natural<L::kKV>(k_tile, k_tile + L::kKV, tid);
    split_natural<L::kKV>(v_tile, v_tile + L::kKV, tid);
    fence_proxy_async();
    mbar_arrive(&bar.kv_ready);
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % kSA, t = it % kST;
      if (tid < 32 && it + kSA - 1 < n_iter) issue(it + kSA - 1);
      unsigned char* a = smem + L::kOffA + s * L::kSlotA;
      unsigned char* tt = smem + L::kOffT + t * L::kSlotT;
      mbar_wait(&bar.full[s], (it / kSA) & 1);
      split_natural<L::kTile>(a, a + 2 * L::kTile, tid);              // Q
      split_natural<L::kTile>(a + L::kTile, a + 3 * L::kTile, tid);   // dO
      fence_proxy_async();
      mbar_arrive(&bar.ready_a[s]);
      // The transposes read what other threads split.
      named_barrier_sync<128>(1);
      if (it >= kST) mbar_wait(&bar.empty_t[t], (it / kST - 1) & 1);
      transpose_split<kN, kD, true>(a, tt, tid, a + 2 * L::kTile);     // Q^T
      transpose_split<kN, kD, true>(a + L::kTile, tt + 2 * L::kTile, tid,
                                    a + 3 * L::kTile);                 // dO^T
      fence_proxy_async();
      mbar_arrive(&bar.ready_t[t]);
      // Every producer thread is done reading Q and dO of tile it before a
      // TMA load reuses its slot.
      named_barrier_sync<128>(1);
    }
    return;
  }

  // -------------------------------------------------- consumer
  const int warp = tid / 32, lane = tid % 32;
  const int rq = lane / 4, cq = 2 * (lane % 4);
  const int key0 = k0 + warp * 16 + rq;  // this thread's keys: key0 and key0 + 8
  const float c = scale * kLog2e;
  const uint32_t k_hi = smem_u32(k_tile), v_hi = smem_u32(v_tile);

  constexpr int kAcc = kD / 2;  // dK and dV accumulators a thread, each
  constexpr int kS = kN / 2;    // S^T and dP^T accumulators a thread, each
  float dk[kAcc], dv[kAcc], st[kS], dp[kS];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) dk[i] = dv[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < kS; ++i) st[i] = dp[i] = 0.0f;
  mbar_wait(&bar.kv_ready, 0);

  for (int it = 0; it < n_iter; ++it) {
    const int s = it % kSA, t = it % kST;
    const int q0 = (q_begin + it % n_qt) * kN;
    const uint32_t a = smem_u32(smem + L::kOffA + s * L::kSlotA);
    const float* lse_s = rows + s * 2 * kN;
    const float* dl = lse_s + kN;
    mbar_wait(&bar.ready_a[s], (it / kSA) & 1);

    // S^T = K Q^T and dP^T = V dO^T over the head dim, two commit groups.
    fence_regs(st);
    fence_regs(dp);
    wgmma_fence();
    product_ss<kD, kN>(st, k_hi, k_hi + L::kKV, a, a + 2 * L::kTile);
    wgmma_commit();
    product_ss<kD, kN>(dp, v_hi, v_hi + L::kKV, a + L::kTile, a + 3 * L::kTile);
    wgmma_commit();
    // lse * log2 e and delta of this thread's columns (queries): column i
    // is 8 (i / 4) + cq + i % 2.
    float ls[kS], ds[kS];
#pragma unroll
    for (int i = 0; i < kS; i += 2) {
      const int col = (i / 4) * 8 + cq;
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + col);
      const float2 d2 = *reinterpret_cast<const float2*>(dl + col);
      ls[i] = l2.x * kLog2e;
      ls[i + 1] = l2.y * kLog2e;
      ds[i] = d2.x;
      ds[i + 1] = d2.y;
    }
    wgmma_wait<1>();
    fence_regs(st);
    const bool mask = (causal && q0 < k0 + kKeys - 1) || q0 + kN > Sq;
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      st[i] = exp2f(fmaf(st[i], c, -ls[i]));
      if (mask) {
        const int key = key0 + ((i / 2) % 2) * 8;
        const int qi = q0 + (i / 4) * 8 + cq + i % 2;
        if (qi >= Sq || (causal && qi < key)) st[i] = 0.0f;
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);
    mbar_arrive(&bar.empty_a[s]);
    // dS^T = P^T (dP^T - delta), then both split into A fragments.
#pragma unroll
    for (int i = 0; i < kS; ++i) dp[i] = st[i] * (dp[i] - ds[i]);
    uint32_t ph[kS], pl[kS], dh[kS], dlo[kS];
    split_frags(st, ph, pl);
    split_frags(dp, dh, dlo);
    const uint32_t tt = smem_u32(smem + L::kOffT + t * L::kSlotT);
    mbar_wait(&bar.ready_t[t], (it / kST) & 1);
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(ph);
    fence_regs(pl);
    fence_regs(dh);
    fence_regs(dlo);
    wgmma_fence();
    product_rs<kN, kD>(dv, ph, pl, tt + 2 * L::kTile);  // dO^T
    product_rs<kN, kD>(dk, dh, dlo, tt);                // Q^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(ph);
    fence_regs(pl);
    fence_regs(dh);
    fence_regs(dlo);
    mbar_arrive(&bar.empty_t[t]);
  }

  // Epilogue: dK * scale and dV into the K and V (hi) tiles (read by no one
  // any more), in the swizzled layout the TMA store reads.
#pragma unroll
  for (int i = 0; i < kAcc; i += 2) {
    const int r = warp * 16 + rq + ((i / 2) % 2) * 8;
    const int col = (i / 4) * 8 + cq;
    const uint32_t off = panel_offset(kKeys, r, col);
    *reinterpret_cast<float2*>(k_tile + off) = make_float2(dk[i] * scale, dk[i + 1] * scale);
    *reinterpret_cast<float2*>(v_tile + off) = make_float2(dv[i], dv[i + 1]);
  }
  fence_proxy_async();
  named_barrier_sync<128>(2);
  if (tid == 0) {
    for (int p = 0; p < kD / 32; ++p) {
      tma_store_4d(&dk_map, k_tile + p * kKeys * 128, p * 32, kvh, k0, b);
      tma_store_4d(&dv_map, v_tile + p * kKeys * 128, p * 32, kvh, k0, b);
    }
    tma_store_wait();
  }
}

// Launch the kD instance (64 or 128) on tensors of head_dim D (kD / 2 < D
// <= kD).
template <int kD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dk, void* dv, int B, int H,
                   int KVH, int Sq, int Sk, int D, int causal, float scale, void* stream) {
  constexpr int kSmemBytes = Smem<kD>::kBytes;
  constexpr int kN = Smem<kD>::kN;
  constexpr CUtensorMapDataType kF32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap q_map, k_map, v_map, do_map, dk_map, dv_map;
  cudaError_t err = make_bshd_map(&q_map, q, B, Sq, H, D, kN, kF32);
  if (err == cudaSuccess) err = make_bshd_map(&do_map, dout, B, Sq, H, D, kN, kF32);
  if (err == cudaSuccess) err = make_bshd_map(&k_map, k, B, Sk, KVH, D, kKeys, kF32);
  if (err == cudaSuccess) err = make_bshd_map(&v_map, v, B, Sk, KVH, D, kKeys, kF32);
  if (err == cudaSuccess) err = make_bshd_map(&dk_map, dk, B, Sk, KVH, D, kKeys, kF32);
  if (err == cudaSuccess) err = make_bshd_map(&dv_map, dv, B, Sk, KVH, D, kKeys, kF32);
  if (err == cudaSuccess) err = allow_smem(flash_dkv_f32_kernel<kD>, kSmemBytes);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>((Sk + kKeys - 1) / kKeys) * B * KVH;
  flash_dkv_f32_kernel<kD><<<blocks, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      q_map, k_map, v_map, do_map, dk_map, dv_map, static_cast<const float*>(lse),
      static_cast<const float*>(delta), B, H, KVH, Sq, Sk, causal, scale);
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
    err = cuda_cores::launch_fma<256>(q, k, v, dout, lse, delta, dk, dv, B, H, KVH, Sq, Sk, D,
                                      causal, scale, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  TK_RETURN_LAST_ERROR();
}
