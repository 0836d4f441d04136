// Flash attention forward on fp32 inputs: o and the per-row logsumexp, BSHD
// in and out, every product fp32-accurate (3xTF32 on the tensor cores) and
// every sum in fp32.
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
// Design (sm_90a; tf32x3.cuh for the split, the layouts and the products,
// hopper.cuh for barriers and TMA). Three instances, kD = 64, 128 and 256,
// serve head dims 8..64, 72..128 and 136..256 (multiples of 8); the tensor
// maps carry the true head dim, so TMA zero-fills the columns past it and
// a k8 step past it multiplies zeros. One block per (64 Q rows, q head,
// batch), the longest causal blocks first; its last warpgroup produces and
// the others (two at kD 64 and 128, one at 256) consume:
// - the producer loads Q once by TMA and splits it in place (hi rounded
//   over Q, Q lo beside it), then streams the K and V tiles by TMA into a
//   ring of A slots, a tile ahead, and for each tile splits K in place
//   (then signals ready_a) and writes V^T hi and lo, split from the raw V,
//   into a ring of T slots (then ready_t): V must be transposed because
//   a .tf32 operand is K-major only, and its keys go in the order that
//   makes a consumer's P accumulator the A fragment as it stands
//   (tf32x3.cuh);
// - consumer w takes key tiles w, w + 2, ... (each in a slot of its own)
//   with a softmax state of its own: it computes S = Q K^T as three wgmma
//   m64nNk8 passes a k8 step with both operands from shared memory (lo(Q)
//   hi(K), hi(Q) lo(K), hi(Q) hi(K)), frees the A slot, runs the online
//   softmax on the accumulator registers (exp2f), splits P into hi and lo
//   in registers (cvt.rna.tf32) and adds P V as three register-A passes
//   over V^T (m64n64k8 at kD 64, m64n128k8 at 128, two at 256), then frees
//   the T slot. At the end consumer 1 hands its m, l and accumulators to
//   consumer 0 through shared memory, which merges the two states.
// So the producer's TMA waits and splitting passes overlap the consumers'
// products, and one consumer's softmax the other's products. No product
// runs on the CUDA cores.
// - Causal: K tiles past the block's last row are never loaded, only tiles
//   that cross the diagonal (or the ragged end of the keys) are masked.
// - Epilogue: o = acc / l in registers, staged in the Q (hi) tile and written
//   by TMA store (rows past the end and columns past the head dim are not
//   written); lse from registers.
// Shared memory (KB = 1024 bytes): Q (hi) and Q lo 2 x 64 rows; an A slot
// holds K (hi), K lo and V, a T slot V^T hi and lo (two columns a key),
// each of kN keys:
//   kD 64:  kN 64, Q 32 + 2 A slots x 48 + 2 T slots x 32 = 192 KB;
//   kD 128: kN 32, Q 64 + 2 x 48 + 2 x 32 = 224 KB;
//   kD 256: kN 16, Q 128 + 1 x 48 + 1 x 32 = 208 KB (one slot each, one
//           consumer: the next tile's TMA waits until S of this one is
//           done, its split until P V is done).
// One block an SM. What sets the time at kD 128 is shared-memory traffic:
// the passes re-read Q for every k8 step, and the producer's splits read
// and write each K and V tile again; taking out either costs as much as
// the other, the softmax little (PERF.md).

#include "tf32x3.cuh"

namespace {

using namespace hopper;
using namespace tf32x3;

constexpr int kRows = 64;       // Q rows of a block: every consumer warpgroup's
constexpr int kMaxSlots = 2;

struct Barriers {
  uint64_t q_full;                // Q has landed
  uint64_t q_ready;               // Q is split: hi in place, lo beside
  uint64_t full[kMaxSlots];       // K and V of the A slot have landed
  uint64_t ready_a[kMaxSlots];    // K is split: hi in place, lo beside
  uint64_t empty_a[kMaxSlots];    // the consumer is done with K and K lo
  uint64_t ready_t[kMaxSlots];    // V^T hi and lo are written
  uint64_t empty_t[kMaxSlots];    // the consumer is done with them
};

template <int kD>
struct Smem {
  static constexpr int kN = kD == 64 ? 64 : (kD == 128 ? 32 : 16);  // keys of a tile
  // Consumer warpgroups, each on every kConsumers-th key tile of the same
  // Q rows, in a slot of its own; the producer is the warpgroup after them.
  static constexpr int kConsumers = kD > 128 ? 1 : 2;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kSlotsA = kD > 128 ? 1 : 2;
  static constexpr int kSlotsT = kD > 128 ? 1 : 2;
  static constexpr int kQ = kRows * kD * 4;       // Q (hi) or Q lo
  static constexpr int kTile = kN * kD * 4;       // K (hi), K lo or V of a tile
  static constexpr int kSlotA = 3 * kTile;        // K (hi), K lo, V
  static constexpr int kSlotT = 2 * kTile;        // V^T hi and lo
  static constexpr int kOffQ = 0;
  static constexpr int kOffQlo = kQ;
  static constexpr int kOffA = 2 * kQ;
  static constexpr int kOffT = kOffA + kSlotsA * kSlotA;
  static constexpr int kOffBar = kOffT + kSlotsT * kSlotT;
  static constexpr int kBytes = kOffBar + sizeof(Barriers) + 1024;  // + alignment slack
};

// One tile's step of the online softmax on the S accumulator (two rows a
// thread: row0 and row0 + 8; kS = the tile's keys / 2 values): mask (only
// where `masked`), the new row max over the quad, P = exp2(s * c - m * c)
// in place, l += this thread's share of the row sum; returns the factors
// that rescale the old accumulator.
template <int kS>
__device__ __forceinline__ void softmax_step(float (&sc)[kS], float& m0, float& m1, float& l0,
                                             float& l1, float& alpha0, float& alpha1,
                                             bool masked, int k0, int row0, int cq, int Sk,
                                             int causal, float c) {
  if (masked) {
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      const int col = k0 + (i / 4) * 8 + cq + (i % 2);
      const int row = row0 + ((i / 2) % 2) * 8;
      if (col >= Sk || (causal && col > row)) sc[i] = -INFINITY;
    }
  }
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int i = 0; i < kS; i += 4) {
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
  alpha0 = exp2f(m0 * c - ms0);
  alpha1 = exp2f(m1 * c - ms1);
  m0 = mx0;
  m1 = mx1;
  float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
  for (int i = 0; i < kS; i += 4) {
    sc[i] = exp2f(fmaf(sc[i], c, -ms0));
    sc[i + 1] = exp2f(fmaf(sc[i + 1], c, -ms0));
    sc[i + 2] = exp2f(fmaf(sc[i + 2], c, -ms1));
    sc[i + 3] = exp2f(fmaf(sc[i + 3], c, -ms1));
    sum0 += sc[i] + sc[i + 1];
    sum1 += sc[i + 2] + sc[i + 3];
  }
  l0 = l0 * alpha0 + sum0;  // this thread's columns; the quad sums at the end
  l1 = l1 * alpha1 + sum1;
}

template <int kD>
__global__ void __launch_bounds__(Smem<kD>::kThreads, 1) flash_fwd_f32_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap o_map,
    float* __restrict__ lse, int B, int H, int KVH, int Sq, int Sk, int causal, float scale) {
  using L = Smem<kD>;
  constexpr int kN = L::kN, kSA = L::kSlotsA, kST = L::kSlotsT, kC = L::kConsumers;
  static_assert(kC == 1 || (kSA == kC && kST == kC), "a slot of its own a consumer");
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

  if (wg == kC) {
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
      mbar_arrive_expect_tx(&bar.q_full, L::kQ);
      for (int p = 0; p < kD / 32; ++p)
        tma_load_4d(smem + L::kOffQ + p * kRows * 128, &q_map, &bar.q_full, p * 32, h, q0, b);
      for (int j = 0; j < kSA - 1 && j < k_end; ++j) issue(j);
    }
    mbar_wait(&bar.q_full, 0);
    split_natural<L::kQ>(smem + L::kOffQ, smem + L::kOffQlo, tid);
    fence_proxy_async();
    mbar_arrive(&bar.q_ready);
    for (int j = 0; j < k_end; ++j) {
      const int s = j % kSA, t = j % kST;
      if (tid == 0 && j + kSA - 1 < k_end) issue(j + kSA - 1);
      unsigned char* a = smem + L::kOffA + s * L::kSlotA;
      mbar_wait(&bar.full[s], (j / kSA) & 1);
      split_natural<L::kTile>(a, a + L::kTile, tid);
      fence_proxy_async();
      mbar_arrive(&bar.ready_a[s]);
      if (j >= kST) mbar_wait(&bar.empty_t[t], (j / kST - 1) & 1);
      transpose_split<kN, kD>(a + 2 * L::kTile, smem + L::kOffT + t * L::kSlotT, tid);
      fence_proxy_async();
      mbar_arrive(&bar.ready_t[t]);
      // Every producer thread is done reading V of tile j before a TMA
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
  unsigned char* q_tile = smem + L::kOffQ;
  const uint32_t q_hi = smem_u32(q_tile), q_lo = smem_u32(smem + L::kOffQlo);

  constexpr int kAcc = kD / 2;  // O accumulators a thread
  constexpr int kS = kN / 2;    // S accumulators a thread
  float acc[kAcc], sc[kS];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < kS; ++i) sc[i] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
  mbar_wait(&bar.q_ready, 0);

  for (int j = wg; j < k_end; j += kC) {
    const int s = j % kSA, t = j % kST;
    const uint32_t k_hi = smem_u32(smem + L::kOffA + s * L::kSlotA);
    mbar_wait(&bar.ready_a[s], (j / kSA) & 1);
    fence_regs(sc);
    wgmma_fence();
    product_ss<kD, kN>(sc, q_hi, q_lo, k_hi, k_hi + L::kTile);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    mbar_arrive(&bar.empty_a[s]);

    const int k0 = j * kN;
    float alpha0, alpha1;
    const bool masked = (causal && k0 + kN - 1 > q0) || k0 + kN > Sk;
    softmax_step(sc, m0, m1, l0, l1, alpha0, alpha1, masked, k0, row0, cq, Sk, causal, c);
#pragma unroll
    for (int i = 0; i < kAcc; i += 4) {
      acc[i] *= alpha0;
      acc[i + 1] *= alpha0;
      acc[i + 2] *= alpha1;
      acc[i + 3] *= alpha1;
    }
    uint32_t ph[kS], pl[kS];
    split_frags(sc, ph, pl);
    mbar_wait(&bar.ready_t[t], (j / kST) & 1);
    fence_regs(acc);
    fence_regs(ph);
    fence_regs(pl);
    wgmma_fence();
    product_rs<kN, kD>(acc, ph, pl, smem_u32(smem + L::kOffT + t * L::kSlotT));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(ph);
    fence_regs(pl);
    mbar_arrive(&bar.empty_t[t]);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  if (kC == 2) {
    // Merge the two consumers' softmax states: warpgroup 1 hands its
    // accumulators (thread tid holds the same rows and columns in both)
    // through Q lo and its m and l through A slot 0, once warpgroup 0's
    // last product has read Q lo and no tile is left in flight.
    float* xacc = reinterpret_cast<float*>(smem + L::kOffQlo);
    float* xml = reinterpret_cast<float*>(smem + L::kOffA);
    named_barrier_sync<256>(3);
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < kAcc; ++i) xacc[i * 128 + tid] = acc[i];
      xml[tid] = m0;
      xml[128 + tid] = m1;
      xml[256 + tid] = l0;
      xml[384 + tid] = l1;
    }
    named_barrier_sync<256>(3);
    if (wg == 1) return;
    const float mb0 = xml[tid], mb1 = xml[128 + tid];
    const float mx0 = fmaxf(m0, mb0), mx1 = fmaxf(m1, mb1);
    const float ms0 = mx0 == -INFINITY ? 0.0f : mx0 * c;
    const float ms1 = mx1 == -INFINITY ? 0.0f : mx1 * c;
    const float fa0 = exp2f(m0 * c - ms0), fb0 = exp2f(mb0 * c - ms0);
    const float fa1 = exp2f(m1 * c - ms1), fb1 = exp2f(mb1 * c - ms1);
    l0 = l0 * fa0 + xml[256 + tid] * fb0;
    l1 = l1 * fa1 + xml[384 + tid] * fb1;
    m0 = mx0;
    m1 = mx1;
#pragma unroll
    for (int i = 0; i < kAcc; i += 4) {
      acc[i] = acc[i] * fa0 + xacc[i * 128 + tid] * fb0;
      acc[i + 1] = acc[i + 1] * fa0 + xacc[(i + 1) * 128 + tid] * fb0;
      acc[i + 2] = acc[i + 2] * fa1 + xacc[(i + 2) * 128 + tid] * fb1;
      acc[i + 3] = acc[i + 3] * fa1 + xacc[(i + 3) * 128 + tid] * fb1;
    }
  }

  // Epilogue: o = acc / l into the Q (hi) tile (read by no one any more), in
  // the swizzled layout the TMA store reads.
  const float inv0 = 1.0f / (l0 == 0.0f ? 1.0f : l0);
  const float inv1 = 1.0f / (l1 == 0.0f ? 1.0f : l1);
#pragma unroll
  for (int i = 0; i < kAcc; i += 2) {
    const int hi = (i / 2) % 2;
    const int r = warp * 16 + rq + hi * 8;
    const int col = (i / 4) * 8 + cq;
    const float inv = hi ? inv1 : inv0;
    *reinterpret_cast<float2*>(q_tile + panel_offset(kRows, r, col)) =
        make_float2(acc[i] * inv, acc[i + 1] * inv);
  }
  fence_proxy_async();
  named_barrier_sync<128>(2);
  if (tid == 0) {
    for (int p = 0; p < kD / 32; ++p)
      tma_store_4d(&o_map, q_tile + p * kRows * 128, p * 32, h, q0, b);
    tma_store_wait();
  }
  if (lane % 4 == 0) {
    float* out = lse + (static_cast<long long>(b) * H + h) * Sq;
    if (row0 < Sq) out[row0] = m0 * scale + logf(l0 == 0.0f ? 1.0f : l0);
    if (row0 + 8 < Sq) out[row0 + 8] = m1 * scale + logf(l1 == 0.0f ? 1.0f : l1);
  }
}

// Launch the kD instance on tensors of head_dim D (kD / 2 < D <= kD).
template <int kD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                   int H, int KVH, int Sq, int Sk, int D, int causal, float scale,
                   void* stream) {
  constexpr int kSmemBytes = Smem<kD>::kBytes;
  constexpr CUtensorMapDataType kF32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap q_map, k_map, v_map, o_map;
  cudaError_t err = make_bshd_map(&q_map, q, B, Sq, H, D, kRows, kF32);
  if (err == cudaSuccess) err = make_bshd_map(&k_map, k, B, Sk, KVH, D, Smem<kD>::kN, kF32);
  if (err == cudaSuccess) err = make_bshd_map(&v_map, v, B, Sk, KVH, D, Smem<kD>::kN, kF32);
  if (err == cudaSuccess) err = make_bshd_map(&o_map, o, B, Sq, H, D, kRows, kF32);
  if (err == cudaSuccess) err = allow_smem(flash_fwd_f32_kernel<kD>, kSmemBytes);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>((Sq + kRows - 1) / kRows) * B * H;
  flash_fwd_f32_kernel<kD><<<blocks, Smem<kD>::kThreads, kSmemBytes,
                             static_cast<cudaStream_t>(stream)>>>(
      q_map, k_map, v_map, o_map, static_cast<float*>(lse), B, H, KVH, Sq, Sk, causal, scale);
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
