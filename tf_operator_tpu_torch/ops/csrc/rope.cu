// Rotary position embedding on [b, s, h, d] activations.
//
// Replaces: tf_operator_tpu/ops/rope_pallas.py:_rope_kernel (launched by
// _rope_raw; the backward, _rope_bwd, is the same kernel with -sin, which
// here is the `inverse` flag).
//
// Computes [x1*cos - x2*sin, x2*cos + x1*sin] on the two halves of the last
// dim (not interleaved) of a bf16 x, in fp32, cast back to bf16; cos/sin
// are [s, d/2] fp32 tables indexed by position. With `inverse` the kernel
// negates sin as it loads it: the rotation by -θ, the transpose, with no
// -sin table built.
//
// Bound on the H100: bytes. It reads x and writes the result once (2 x 33.5
// MB at llama-400m, bs 8, seq 2048) and reads both tables once (1 MB), and
// does 6 flops a pair, far below the card's ratio of ~295 flops a byte.
// Design: every access is 16 bytes. A thread owns 8 consecutive pairs
// (j..j+7) of one (batch, position) and every other head: it loads their
// cos and sin once (two float4 each) and then, for each of its heads, loads
// x1 and x2 as one 16-byte vector each and stores the two results the same
// way. The d/16 threads of a position cover a head's whole row, so a warp
// reads and writes full 128-byte lines; two threads share a position's
// heads (threadIdx.z), which doubles the loads in flight. x is read with
// the evict-first hint: nothing reads it again. The position comes from
// blockIdx.x and threadIdx.y and the batch from blockIdx.y: no index is
// divided. There is no shared memory (the TPU kernel's _block_s sized VMEM
// slabs, which has no counterpart here).

#include "common.cuh"

namespace {

constexpr int kPairs = 8;       // pairs a thread owns: 8 bf16 = 16 bytes
constexpr int kHeadLanes = 2;   // threads that share a position's heads
constexpr int kThreads = 256;

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[kPairs]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < kPairs / 2; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[kPairs]) {
  uint4 v;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < kPairs / 2; ++i) p[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

// Block (half / 8, positions, kHeadLanes); grid (position blocks, batch).
__global__ void __launch_bounds__(kThreads) rope_kernel(
    const bf16* __restrict__ x, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, bf16* __restrict__ out, int S, int H, int half,
    int inverse) {
  const int pos = blockIdx.x * blockDim.y + threadIdx.y;
  if (pos >= S) return;
  const int j = threadIdx.x * kPairs;
  const float4* ct = reinterpret_cast<const float4*>(cos_t + pos * half + j);
  const float4* st = reinterpret_cast<const float4*>(sin_t + pos * half + j);
  const float4 c0 = ct[0], c1 = ct[1], s0 = st[0], s1 = st[1];
  const float sg = inverse ? -1.0f : 1.0f;
  const float c[kPairs] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
  const float s[kPairs] = {sg * s0.x, sg * s0.y, sg * s0.z, sg * s0.w,
                           sg * s1.x, sg * s1.y, sg * s1.z, sg * s1.w};

  // In 16-byte units: a head is 2 * half / 8 of them, x2 starts half / 8 in.
  const int head = 2 * half / kPairs;
  const int second = half / kPairs;
  const long long row = static_cast<long long>(blockIdx.y * S + pos) * H * head;
  const uint4* src = reinterpret_cast<const uint4*>(x) + row + threadIdx.x;
  uint4* dst = reinterpret_cast<uint4*>(out) + row + threadIdx.x;
#pragma unroll 4
  for (int hh = threadIdx.z; hh < H; hh += kHeadLanes) {
    float x1[kPairs], x2[kPairs], y1[kPairs], y2[kPairs];
    unpack8(__ldcs(src + hh * head), x1);
    unpack8(__ldcs(src + hh * head + second), x2);
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      y1[i] = x1[i] * c[i] - x2[i] * s[i];
      y2[i] = x2[i] * c[i] + x1[i] * s[i];
    }
    dst[hh * head] = pack8(y1);
    dst[hh * head + second] = pack8(y2);
  }
}

}  // namespace

extern "C" {

const char* tk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int tk_rope(const void* x, const void* cos_t, const void* sin_t, void* out, int B, int S,
            int H, int D, int inverse, void* stream) {
  const int half = D / 2;
  const int lanes = half / kPairs;  // threads of a position
  if (D % (2 * kPairs) != 0 || lanes * kHeadLanes > kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(lanes, kThreads / kHeadLanes / lanes, kHeadLanes);
  const dim3 grid((S + block.y - 1) / block.y, B);
  rope_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<bf16*>(out), S, H, half, inverse);
  TK_RETURN_LAST_ERROR();
}

}  // extern "C"
