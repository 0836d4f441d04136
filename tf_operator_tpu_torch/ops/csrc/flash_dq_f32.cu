// Flash attention backward on fp32 inputs, the dQ half of the
// FlashAttention-2 split (the dK/dV half is flash_dkv_f32.cu), BSHD in and
// out, every product fp32-accurate and every sum in fp32.
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
// over a third of the TF32 peak (3xTF32; device.py TF32_PASSES): 0.6254 ms.
//
// Design at kD = 64 and 128 (head dims 8..64 and 72..128, multiples of 8;
// sm_90a, tf32x3.cuh for the split, the layouts and the products, hopper.cuh
// for barriers and TMA): 3xTF32 on wgmma, the dK/dV kernel's shape
// mirrored. One block per (64 Q rows, q head, batch), the longest causal
// blocks first, of two warpgroups:
// - the producer (warpgroup 1) loads Q and dO once by TMA and splits them
//   in place (hi rounded over the raw tile, lo beside it), then streams the
//   K and V tiles of kN keys by TMA into a ring of A slots, a tile ahead;
//   for each tile it splits K and V in place (then signals ready_a) and,
//   once all of its threads have, writes K^T hi and lo, from those hi and
//   lo, into a ring of T slots (then ready_t): dQ += dS K takes K with the
//   keys as the product's K, and a .tf32 operand is K-major only; the keys
//   go in the order that makes the consumer's dS accumulator the A
//   fragment as it stands (tf32x3.cuh).
// - the consumer (warpgroup 0) keeps its rows' lse and delta in registers
//   for the whole block; for each tile it computes S = Q K^T and dP = dO
//   V^T, each three wgmma m64nNk8 passes a k8 step with both operands from
//   shared memory, frees the A slot, forms P = exp2(S * scale * log2 e -
//   lse * log2 e) and dS = P (dP - delta) on the accumulator registers,
//   splits dS into hi and lo (cvt.rna.tf32) and adds dS K to the dQ
//   accumulator in registers (kD / 2 fp32 a thread) as three register-A
//   passes over K^T (m64n64k8 at kD 64, m64n128k8 at 128); then frees the T
//   slot. No product runs on the CUDA cores.
// - Causal: key tiles past the block's last row are never loaded, and only
//   tiles that cross the diagonal (or the ragged end of the keys) are
//   masked.
// - Epilogue: dQ * scale staged in the Q (hi) tile and written by TMA store
//   (rows past the end and columns past the head dim are not written).
// Shared memory (KB = 1024 bytes): Q, Q lo, dO and dO lo of 64 rows (64 KB
// at kD 64, 128 at 128); an A slot holds K, K lo, V and V lo (kN kD 16
// bytes), a T slot K^T hi and lo (kN kD 8 bytes), each of kN keys:
//   kD 64:  kN 64, 64 + 2 A slots x 64 + 1 T slot x 32 = 224 KB;
//   kD 128: kN 32, 128 + 1 x 64 + 1 x 32 = 224 KB (the next tile's TMA
//           waits until this one's S and dP are done, its transpose until
//           this one's dS K is).
// The other tiling, half as many keys a tile with two slots of each (kN
// 32: 160 KB, kN 16: 224 KB), keeps a tile in flight but re-reads Q and dO
// in the S and dP passes twice as often a key: at [8, 2048, 8, D] fp32
// causal on an H100 SXM at 700 W it took 0.8150 / 2.0164 ms at D = 64 /
// 128 against 0.6232 / 1.6727 for this one (fp32_flash_ab's
// "dq_narrow_tiles"; PERF.md). One block an SM. ptxas (chip_smoke.py
// phase b): 130 registers at kD 64 and 126 at 128 (__launch_bounds__ of
// 256 threads), no spill.
//
// kD = 256 (head dims 136..256) stays on FMAs on the CUDA cores
// (flash_f32.cuh, flash_dq_f32_kernel_fma below): Q, Q lo, dO and dO lo
// for the 64 rows a warpgroup's wgmma needs take 256 KB, past the 227 KB a
// block may have, before any K or V tile; a design that streams the head
// dim in chunks is a redesign of its own (ROADMAP.md, Queue 2).

#include "flash_f32.cuh"
#include "tf32x3.cuh"

namespace cuda_cores {

using namespace f32;

// The FMA kernel, at kD 256 only: one block of 256 threads per (64 Q rows,
// q head, batch), the longest causal blocks first; each thread keeps its 4
// rows' lse and delta in registers. The Q and dO tiles are loaded once;
// for each K/V tile of 32 keys the block computes S and dP (4 x 2 a thread
// each) by FMAs, dS in registers, writes dS transposed to shared memory
// and adds dS K to the dQ accumulator (4 rows x 16 columns a thread).
// Shared memory: Q, dO [64][260], K, V [32][260] and dS [32][68] floats:
// 208 KB.
template <int kD>
struct Tiles {
  static constexpr int kBlockN = 32;                 // keys of a K/V tile
  static constexpr int kJ = kBlockN / 16;            // S columns a thread
  static constexpr int kBytes = (2 * kRows * stride<kD>() + 2 * kBlockN * stride<kD>() +
                                 kBlockN * kTStride) * 4;
};

template <int kD>
__global__ void __launch_bounds__(kThreads, 1) flash_dq_f32_kernel_fma(
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
cudaError_t launch_fma(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dq, int B, int H, int KVH,
                       int Sq, int Sk, int D, int causal, float scale, void* stream) {
  constexpr int kBytes = Tiles<kD>::kBytes;
  const cudaError_t err = allow_smem(flash_dq_f32_kernel_fma<kD>, kBytes);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>((Sq + kRows - 1) / kRows) * B * H;
  flash_dq_f32_kernel_fma<kD><<<blocks, kThreads, kBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), B, H, KVH, Sq, Sk, D, causal,
      scale);
  return cudaSuccess;
}

}  // namespace cuda_cores

namespace {

using namespace hopper;
using namespace tf32x3;

constexpr int kRows = 64;       // Q rows of a block: the consumer warpgroup's
constexpr int kThreads = 256;   // warpgroup 0 consumes, warpgroup 1 produces
constexpr int kMaxSlots = 2;

struct Barriers {
  uint64_t q_full;                // Q and dO have landed
  uint64_t q_ready;               // Q and dO are split: hi in place, lo beside
  uint64_t full[kMaxSlots];       // K and V of the A slot have landed
  uint64_t ready_a[kMaxSlots];    // K and V are split: hi in place, lo beside
  uint64_t empty_a[kMaxSlots];    // the consumer is done with the A slot
  uint64_t ready_t[kMaxSlots];    // K^T hi and lo are written
  uint64_t empty_t[kMaxSlots];    // the consumer is done with them
};

template <int kD>
struct Smem {
  static constexpr int kN = kD == 64 ? 64 : 32;  // keys of a K/V tile
  static constexpr int kSlotsA = kD == 64 ? 2 : 1;
  static constexpr int kSlotsT = 1;
  static constexpr int kQ = kRows * kD * 4;       // Q, dO or a lo of them
  static constexpr int kTile = kN * kD * 4;       // K, V or a lo of them
  static constexpr int kSlotA = 4 * kTile;        // K, K lo, V, V lo
  static constexpr int kSlotT = 2 * kTile;        // K^T hi | lo
  static constexpr int kOffQ = 0;                 // Q, Q lo, dO, dO lo
  static constexpr int kOffA = 4 * kQ;
  static constexpr int kOffT = kOffA + kSlotsA * kSlotA;
  static constexpr int kOffBar = kOffT + kSlotsT * kSlotT;
  static constexpr int kBytes = kOffBar + sizeof(Barriers) + 1024;  // + alignment slack
  static_assert(kSlotsA <= kMaxSlots && kSlotsT <= kMaxSlots, "barriers for every slot");
};

template <int kD>
__global__ void __launch_bounds__(kThreads, 1) flash_dq_f32_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
    const __grid_constant__ CUtensorMap dq_map, const float* __restrict__ lse,
    const float* __restrict__ delta, int B, int H, int KVH, int Sq, int Sk, int causal,
    float scale) {
  using L = Smem<kD>;
  constexpr int kN = L::kN, kSA = L::kSlotsA, kST = L::kSlotsT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  Barriers& bar = *reinterpret_cast<Barriers*>(smem + L::kOffBar);

  const int n_q = (Sq + kRows - 1) / kRows;
  const int bh = static_cast<int>(blockIdx.x) % (B * H);
  const int qt = n_q - 1 - static_cast<int>(blockIdx.x) / (B * H);  // longest first
  const int h = bh % H, b = bh / H;
  const int kvh = h / (H / KVH);
  const int q0 = qt * kRows;
  const int n_k = (Sk + kN - 1) / kN;
  // Causal: K tiles past the block's last row are invisible to every row.
  const int k_end = causal ? min(n_k, (q0 + kRows + kN - 1) / kN) : n_k;

  if (threadIdx.x == 0) {
    mbar_init(&bar.q_full, 1);
    mbar_init(&bar.q_ready, 128);
    for (int s = 0; s < kMaxSlots; ++s) {
      mbar_init(&bar.full[s], 1);
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
  unsigned char* q_tile = smem + L::kOffQ;
  unsigned char* do_tile = smem + L::kOffQ + 2 * L::kQ;

  if (wg == 1) {
    // ------------------------------------------------ producer
    // K and V of tile j into A slot j % kSA, once the consumer is done with
    // the slot's last tile (the producer itself is: see the barrier below).
    const CUtensorMap* k_tma = &k_map;
    const CUtensorMap* v_tma = &v_map;
    auto issue = [&](int j) {
      const int s = j % kSA;
      if (j >= kSA) mbar_wait(&bar.empty_a[s], (j / kSA - 1) & 1);
      unsigned char* a = smem + L::kOffA + s * L::kSlotA;
      mbar_arrive_expect_tx(&bar.full[s], 2 * L::kTile);
      for (int p = 0; p < kD / 32; ++p) {
        tma_load_4d(a + p * kN * 128, k_tma, &bar.full[s], p * 32, kvh, j * kN, b);
        tma_load_4d(a + 2 * L::kTile + p * kN * 128, v_tma, &bar.full[s], p * 32, kvh, j * kN,
                    b);
      }
    };
    if (tid == 0) {
      mbar_arrive_expect_tx(&bar.q_full, 2 * L::kQ);
      for (int p = 0; p < kD / 32; ++p) {
        tma_load_4d(q_tile + p * kRows * 128, &q_map, &bar.q_full, p * 32, h, q0, b);
        tma_load_4d(do_tile + p * kRows * 128, &do_map, &bar.q_full, p * 32, h, q0, b);
      }
      for (int j = 0; j < kSA - 1 && j < k_end; ++j) issue(j);
    }
    mbar_wait(&bar.q_full, 0);
    split_natural<L::kQ>(q_tile, q_tile + L::kQ, tid);
    split_natural<L::kQ>(do_tile, do_tile + L::kQ, tid);
    fence_proxy_async();
    mbar_arrive(&bar.q_ready);
    for (int j = 0; j < k_end; ++j) {
      const int s = j % kSA, t = j % kST;
      if (tid == 0 && j + kSA - 1 < k_end) issue(j + kSA - 1);
      unsigned char* a = smem + L::kOffA + s * L::kSlotA;
      mbar_wait(&bar.full[s], (j / kSA) & 1);
      split_natural<L::kTile>(a, a + L::kTile, tid);                      // K
      split_natural<L::kTile>(a + 2 * L::kTile, a + 3 * L::kTile, tid);   // V
      fence_proxy_async();
      mbar_arrive(&bar.ready_a[s]);
      // The transpose reads what other threads split.
      named_barrier_sync<128>(1);
      if (j >= kST) mbar_wait(&bar.empty_t[t], (j / kST - 1) & 1);
      transpose_split<kN, kD, true>(a, smem + L::kOffT + t * L::kSlotT, tid, a + L::kTile);
      fence_proxy_async();
      mbar_arrive(&bar.ready_t[t]);
      // Every producer thread is done reading K of tile j before a TMA
      // load reuses its slot.
      named_barrier_sync<128>(1);
    }
    return;
  }

  // -------------------------------------------------- consumer
  const int warp = tid / 32, lane = tid % 32;
  const int rq = lane / 4, cq = 2 * (lane % 4);
  const int row0 = q0 + warp * 16 + rq;  // rows row0 and row0 + 8
  const float c = scale * kLog2e;
  // lse * log2 e and delta of the thread's two rows, 0 for rows past the
  // end (their Q and dO rows are zeros, so their dS is 0).
  const long long rows = (static_cast<long long>(b) * H + h) * Sq;
  const float ls0 = row0 < Sq ? lse[rows + row0] * kLog2e : 0.0f;
  const float ls1 = row0 + 8 < Sq ? lse[rows + row0 + 8] * kLog2e : 0.0f;
  const float dl0 = row0 < Sq ? delta[rows + row0] : 0.0f;
  const float dl1 = row0 + 8 < Sq ? delta[rows + row0 + 8] : 0.0f;
  const uint32_t q_hi = smem_u32(q_tile), do_hi = smem_u32(do_tile);

  constexpr int kAcc = kD / 2;  // dQ accumulators a thread
  constexpr int kS = kN / 2;    // S and dP accumulators a thread, each
  float acc[kAcc], sc[kS], dp[kS];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < kS; ++i) sc[i] = dp[i] = 0.0f;
  mbar_wait(&bar.q_ready, 0);

  for (int j = 0; j < k_end; ++j) {
    const int s = j % kSA, t = j % kST;
    const uint32_t a = smem_u32(smem + L::kOffA + s * L::kSlotA);
    mbar_wait(&bar.ready_a[s], (j / kSA) & 1);

    // S = Q K^T and dP = dO V^T over the head dim, two commit groups.
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
    product_ss<kD, kN>(sc, q_hi, q_hi + L::kQ, a, a + L::kTile);
    wgmma_commit();
    product_ss<kD, kN>(dp, do_hi, do_hi + L::kQ, a + 2 * L::kTile, a + 3 * L::kTile);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);
    const int k0 = j * kN;
    const bool mask = (causal && k0 + kN - 1 > q0) || k0 + kN > Sk;
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      const bool second = (i / 2) % 2;  // row0 + 8
      sc[i] = exp2f(fmaf(sc[i], c, second ? -ls1 : -ls0));
      if (mask) {
        const int col = k0 + (i / 4) * 8 + cq + i % 2;
        const int row = row0 + 8 * second;
        if (col >= Sk || (causal && col > row)) sc[i] = 0.0f;
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);
    mbar_arrive(&bar.empty_a[s]);
    // dS = P (dP - delta), then split into A fragments.
#pragma unroll
    for (int i = 0; i < kS; ++i) dp[i] = sc[i] * (dp[i] - ((i / 2) % 2 ? dl1 : dl0));
    uint32_t dh[kS], dlo[kS];
    split_frags(dp, dh, dlo);
    mbar_wait(&bar.ready_t[t], (j / kST) & 1);
    fence_regs(acc);
    fence_regs(dh);
    fence_regs(dlo);
    wgmma_fence();
    product_rs<kN, kD>(acc, dh, dlo, smem_u32(smem + L::kOffT + t * L::kSlotT));  // K^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(dh);
    fence_regs(dlo);
    mbar_arrive(&bar.empty_t[t]);
  }

  // Epilogue: dQ * scale into the Q (hi) tile (read by no one any more), in
  // the swizzled layout the TMA store reads.
#pragma unroll
  for (int i = 0; i < kAcc; i += 2) {
    const int r = warp * 16 + rq + ((i / 2) % 2) * 8;
    const int col = (i / 4) * 8 + cq;
    *reinterpret_cast<float2*>(q_tile + panel_offset(kRows, r, col)) =
        make_float2(acc[i] * scale, acc[i + 1] * scale);
  }
  fence_proxy_async();
  named_barrier_sync<128>(2);
  if (tid == 0) {
    for (int p = 0; p < kD / 32; ++p)
      tma_store_4d(&dq_map, q_tile + p * kRows * 128, p * 32, h, q0, b);
    tma_store_wait();
  }
}

// Launch the kD instance (64 or 128) on tensors of head_dim D (kD / 2 < D
// <= kD).
template <int kD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dq, int B, int H, int KVH, int Sq,
                   int Sk, int D, int causal, float scale, void* stream) {
  constexpr int kSmemBytes = Smem<kD>::kBytes;
  constexpr int kN = Smem<kD>::kN;
  constexpr CUtensorMapDataType kF32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap q_map, k_map, v_map, do_map, dq_map;
  cudaError_t err = make_bshd_map(&q_map, q, B, Sq, H, D, kRows, kF32);
  if (err == cudaSuccess) err = make_bshd_map(&do_map, dout, B, Sq, H, D, kRows, kF32);
  if (err == cudaSuccess) err = make_bshd_map(&dq_map, dq, B, Sq, H, D, kRows, kF32);
  if (err == cudaSuccess) err = make_bshd_map(&k_map, k, B, Sk, KVH, D, kN, kF32);
  if (err == cudaSuccess) err = make_bshd_map(&v_map, v, B, Sk, KVH, D, kN, kF32);
  if (err == cudaSuccess) err = allow_smem(flash_dq_f32_kernel<kD>, kSmemBytes);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>((Sq + kRows - 1) / kRows) * B * H;
  flash_dq_f32_kernel<kD><<<blocks, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      q_map, k_map, v_map, do_map, dq_map, static_cast<const float*>(lse),
      static_cast<const float*>(delta), B, H, KVH, Sq, Sk, causal, scale);
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
    err = cuda_cores::launch_fma<256>(q, k, v, dout, lse, delta, dq, B, H, KVH, Sq, Sk, D,
                                      causal, scale, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  TK_RETURN_LAST_ERROR();
}
