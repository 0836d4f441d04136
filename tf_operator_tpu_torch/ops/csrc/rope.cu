// Rotary position embedding on [b, s, h, d] activations.
//
// Replaces: tf_operator_tpu/ops/rope_pallas.py:_rope_kernel (launched by
// _rope_raw; the backward, _rope_bwd, is the same kernel with -sin, which
// here is the `inverse` flag).
//
// Computes [x1*cos - x2*sin, x2*cos + x1*sin] on the two halves of the last
// dim (not interleaved) of a bf16 or fp32 x, in fp32, written back in x's
// dtype (rope_pallas.py:59); cos/sin are [s, d/2] fp32 tables indexed by
// position. With `inverse` the kernel negates sin as it loads it: the
// rotation by -θ, the transpose, with no -sin table built.
//
// Bound on the H100: bytes. It reads x and writes the result once (2 x 33.5
// MB at llama-400m, bs 8, seq 2048, bf16) and reads both tables once (1
// MB), and does 6 flops a pair, far below the card's ratio of ~295 flops a
// byte.
// Design: every access is as wide as the head dim allows, 16 bytes where it
// can. A thread owns kP consecutive pairs (j..j+kP-1) of one (batch,
// position) and every other head: it loads their cos and sin once (float4s)
// and then, for each of its heads, loads x1 and x2 as one vector each and
// stores the two results the same way. kP is 8 for bf16 (16 bytes) when the
// half dim is a multiple of 8, else 4 (8 bytes: head dims 8, 24, 40 ...),
// and 4 for fp32 (16 bytes); every head dim the kernels take (a multiple of
// 8) has a half dim that is a multiple of 4. The half / kP threads of a
// position cover a head's whole row, so a warp reads and writes whole
// lines; two threads share a position's heads (threadIdx.z), which doubles
// the loads in flight. x is read with the evict-first hint: nothing reads
// it again. The position comes from blockIdx.x and threadIdx.y and the
// batch from blockIdx.y: no index is divided. There is no shared memory
// (the TPU kernel's _block_s sized VMEM slabs, which has no counterpart
// here).

#include "common.cuh"

#include <type_traits>

namespace {

constexpr int kHeadLanes = 2;   // threads that share a position's heads
constexpr int kThreads = 256;

// The vector that holds kP elements of T: 16 or 8 bytes.
template <typename T, int kP>
struct Vec {
  static constexpr int kBytes = kP * static_cast<int>(sizeof(T));
  static_assert(kBytes == 16 || kBytes == 8, "a thread moves 8 or 16 bytes");
  using type = typename std::conditional<kBytes == 16, uint4, uint2>::type;
};

__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) { return __float2bfloat16_rn(v); }
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }

template <typename T, int kP, typename V>
__device__ __forceinline__ void unpack(const V& v, float (&f)[kP]) {
  const T* p = reinterpret_cast<const T*>(&v);
#pragma unroll
  for (int i = 0; i < kP; ++i) f[i] = to_float(p[i]);
}

template <typename T, int kP, typename V>
__device__ __forceinline__ V pack(const float (&f)[kP]) {
  V v;
  T* p = reinterpret_cast<T*>(&v);
#pragma unroll
  for (int i = 0; i < kP; ++i) p[i] = from_float<T>(f[i]);
  return v;
}

// Block (half / kP, positions, kHeadLanes); grid (position blocks, batch).
template <typename T, int kP>
__global__ void __launch_bounds__(kThreads) rope_kernel(
    const T* __restrict__ x, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, T* __restrict__ out, int S, int H, int half,
    int inverse) {
  using V = typename Vec<T, kP>::type;
  const int pos = blockIdx.x * blockDim.y + threadIdx.y;
  if (pos >= S) return;
  const int j = threadIdx.x * kP;
  const float4* ct = reinterpret_cast<const float4*>(cos_t + pos * half + j);
  const float4* st = reinterpret_cast<const float4*>(sin_t + pos * half + j);
  const float sg = inverse ? -1.0f : 1.0f;
  float c[kP], s[kP];
#pragma unroll
  for (int i = 0; i < kP / 4; ++i) {
    const float4 c4 = ct[i], s4 = st[i];
    c[4 * i] = c4.x, c[4 * i + 1] = c4.y, c[4 * i + 2] = c4.z, c[4 * i + 3] = c4.w;
    s[4 * i] = sg * s4.x, s[4 * i + 1] = sg * s4.y;
    s[4 * i + 2] = sg * s4.z, s[4 * i + 3] = sg * s4.w;
  }

  // In vector units: a head is 2 * half / kP of them, x2 starts half / kP in.
  const int head = 2 * half / kP;
  const int second = half / kP;
  const long long row = static_cast<long long>(blockIdx.y * S + pos) * H * head;
  const V* src = reinterpret_cast<const V*>(x) + row + threadIdx.x;
  V* dst = reinterpret_cast<V*>(out) + row + threadIdx.x;
#pragma unroll 4
  for (int hh = threadIdx.z; hh < H; hh += kHeadLanes) {
    float x1[kP], x2[kP], y1[kP], y2[kP];
    unpack<T, kP>(__ldcs(src + hh * head), x1);
    unpack<T, kP>(__ldcs(src + hh * head + second), x2);
#pragma unroll
    for (int i = 0; i < kP; ++i) {
      y1[i] = x1[i] * c[i] - x2[i] * s[i];
      y2[i] = x2[i] * c[i] + x1[i] * s[i];
    }
    dst[hh * head] = pack<T, kP, V>(y1);
    dst[hh * head + second] = pack<T, kP, V>(y2);
  }
}

template <typename T, int kP>
cudaError_t launch(const void* x, const void* cos_t, const void* sin_t, void* out, int B,
                   int S, int H, int half, int inverse, void* stream) {
  const int lanes = half / kP;  // threads of a position
  if (lanes == 0 || half % kP != 0 || lanes * kHeadLanes > kThreads) return cudaErrorInvalidValue;
  const dim3 block(lanes, kThreads / kHeadLanes / lanes, kHeadLanes);
  const dim3 grid((S + block.y - 1) / block.y, B);
  rope_kernel<T, kP><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<T*>(out), S, H, half, inverse);
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* tk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// bf16 x: 16-byte accesses where the half dim is a multiple of 8, else 8.
int tk_rope(const void* x, const void* cos_t, const void* sin_t, void* out, int B, int S,
            int H, int D, int inverse, void* stream) {
  const int half = D / 2;
  cudaError_t err = cudaErrorInvalidValue;
  if (D % 8 == 0 && half % 8 == 0)
    err = launch<bf16, 8>(x, cos_t, sin_t, out, B, S, H, half, inverse, stream);
  else if (D % 8 == 0)
    err = launch<bf16, 4>(x, cos_t, sin_t, out, B, S, H, half, inverse, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  TK_RETURN_LAST_ERROR();
}

// fp32 x: 16-byte accesses.
int tk_rope_f32(const void* x, const void* cos_t, const void* sin_t, void* out, int B, int S,
                int H, int D, int inverse, void* stream) {
  cudaError_t err = cudaErrorInvalidValue;
  if (D % 8 == 0) err = launch<float, 4>(x, cos_t, sin_t, out, B, S, H, D / 2, inverse, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  TK_RETURN_LAST_ERROR();
}

}  // extern "C"
