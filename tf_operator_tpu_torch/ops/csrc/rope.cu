// Rotary position embedding on [b, s, h, d] activations.
//
// Replaces: tf_operator_tpu/ops/rope_pallas.py:_rope_kernel (launched by
// _rope_raw; the backward is the same kernel with -sin, _rope_bwd).
//
// Computes [x1*cos - x2*sin, x2*cos + x1*sin] on the two halves of the last
// dim (not interleaved) of a bf16 x, in fp32, cast back to bf16; cos/sin
// are [s, d/2] fp32 tables indexed by position.
//
// Bound on the H100: bytes. It reads x and writes the result once (2 x 33.5
// MB at llama-400m, bs 8, seq 2048) and does 6 flops a pair, far below the
// card's ratio of ~295 flops a byte. Design: one thread per rotated pair;
// neighbouring threads take neighbouring pairs, so both halves of a head are
// read and written in coalesced runs; the tables (512 KB) stay in L2. There
// is no shared memory and no block-size budget (the TPU kernel's _block_s
// sized VMEM slabs, which has no counterpart here).

#include "common.cuh"

namespace {

__global__ void __launch_bounds__(256) rope_kernel(
    const bf16* __restrict__ x, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, bf16* __restrict__ out,
    long long n_pairs, int S, int H, int half) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_pairs) return;
  const int j = static_cast<int>(i % half);   // pair index within the head
  const long long row = i / half;             // (b, s, h) row
  const int pos = static_cast<int>((row / H) % S);
  const long long base = row * (2LL * half);
  const float x1 = __bfloat162float(x[base + j]);
  const float x2 = __bfloat162float(x[base + half + j]);
  const float c = cos_t[pos * half + j];
  const float s = sin_t[pos * half + j];
  out[base + j] = __float2bfloat16(x1 * c - x2 * s);
  out[base + half + j] = __float2bfloat16(x2 * c + x1 * s);
}

}  // namespace

extern "C" {

const char* tk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int tk_rope(const void* x, const void* cos_t, const void* sin_t, void* out,
            int B, int S, int H, int D, void* stream) {
  const int half = D / 2;
  const long long n_pairs = static_cast<long long>(B) * S * H * half;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n_pairs + threads - 1) / threads);
  rope_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<bf16*>(out), n_pairs, S, H,
      half);
  TK_RETURN_LAST_ERROR();
}

}  // extern "C"
