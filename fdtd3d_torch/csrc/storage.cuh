// Field storage of the port's kernels: float32, or bfloat16 with float32
// arithmetic (the reference's bf16 storage: fields are stored in bf16,
// every operation, the recursion state (CPML psi, Drude J) and the
// coefficients stay float32). A kernel templated on the storage type T
// loads a field word with ld() (bf16 widened exactly to float) and stores
// with st() (rounded to nearest even, __float2bfloat16_rn, what
// torch's .to(torch.bfloat16) does); a value that stays on chip between
// two updates stays float.

#pragma once

#include <cuda_bf16.h>

typedef __nv_bfloat16 bf16_t;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16_t* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(bf16_t* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// A field word held in a register, widened.
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16_t v) { return __bfloat162float(v); }
