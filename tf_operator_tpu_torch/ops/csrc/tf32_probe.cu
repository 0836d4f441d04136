// One-wgmma probes of how the tensor core reads a .tf32 operand: what the
// fp32 flash kernels (tf32x3.cuh) assume, checked on the card by
// chip_smoke.py (phase b) through ops/flash.py tf32_probe. Not a kernel of
// any model's path; it replaces no TPU kernel.
//
// out[0 .. 511]: D [64 x 8] = A B^T of one m64n8k8 with A and B from shared
// memory, A(m, 0) = vals[m] (m < n_vals <= 64) and 0 elsewhere, B the
// identity: D(m, 0) is vals[m] as the tensor core read it (truncated to
// TF32, rounded, or whole).
// out[512 .. 1023]: D of one m64n8k8 with A from registers, thread (warp w,
// lane l) holding A(m, k) = 8 m + k at a0 (16 w + l / 4, l % 4), a1 (row +
// 8), a2 (column + 4), a3 (both), the fragment layout tf32x3.cuh assumes,
// and B the identity: D(m, n) = 8 m + n wherever that layout holds.

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

__global__ void __launch_bounds__(128) tf32_probe_kernel(const float* __restrict__ vals,
                                                         int n_vals, float* __restrict__ out) {
  __shared__ unsigned char raw[64 * 128 + 8 * 128 + 1024];
  unsigned char* a = align_1024(raw);  // [64][32] fp32, one panel
  unsigned char* bt = a + 64 * 128;    // [8][32]
  const int tid = threadIdx.x;
  for (int i = tid; i < 64 * 32 + 8 * 32; i += 128) reinterpret_cast<float*>(a)[i] = 0.0f;
  __syncthreads();
  if (tid < n_vals && tid < 64) *reinterpret_cast<float*>(a + panel_offset(64, tid, 0)) = vals[tid];
  if (tid < 8) *reinterpret_cast<float*>(bt + panel_offset(8, tid, tid)) = 1.0f;
  fence_proxy_async();
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int row = 16 * warp + g;
  float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  fence_regs(d);
  wgmma_fence();
  wgmma_m64n8k8_tf32_ss(d, kmajor_desc(smem_u32(a)), kmajor_desc(smem_u32(bt)), 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
  out[row * 8 + 2 * t] = d[0];
  out[row * 8 + 2 * t + 1] = d[1];
  out[(row + 8) * 8 + 2 * t] = d[2];
  out[(row + 8) * 8 + 2 * t + 1] = d[3];

  uint32_t f[4] = {__float_as_uint(8.0f * row + t), __float_as_uint(8.0f * (row + 8) + t),
                   __float_as_uint(8.0f * row + t + 4), __float_as_uint(8.0f * (row + 8) + t + 4)};
  float e[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  fence_regs(e);
  fence_regs(f);
  wgmma_fence();
  wgmma_m64n8k8_tf32_rs(e, f[0], f[1], f[2], f[3], kmajor_desc(smem_u32(bt)), 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(e);
  out[512 + row * 8 + 2 * t] = e[0];
  out[512 + row * 8 + 2 * t + 1] = e[1];
  out[512 + (row + 8) * 8 + 2 * t] = e[2];
  out[512 + (row + 8) * 8 + 2 * t + 1] = e[3];
}

}  // namespace

extern "C" int tk_tf32_probe(const void* vals, int n_vals, void* out, void* stream) {
  tf32_probe_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), n_vals, static_cast<float*>(out));
  TK_RETURN_LAST_ERROR();
}
