// Shared helpers of the Hopper kernels (ops/csrc/*.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

typedef __nv_bfloat16 bf16;

// Every C entry point returns this after its launch: a launch refused for
// its shape or shared memory never runs, and only this call reports it.
#define TK_RETURN_LAST_ERROR() return static_cast<int>(cudaGetLastError())
