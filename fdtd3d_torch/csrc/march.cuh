// Word helpers of the x-marching kernels that take V consecutive z cells
// a thread (csrc/packed_eh.cu, csrc/family.cu): loads and stores of a
// V-cell word of the storage type, and its copy into a shared-memory
// ring by cp.async with the commit and wait of its groups.

#pragma once

#include "storage.cuh"

// V consecutive cells as floats from a word of T at p (aligned to the
// word), and back (bf16 rounded to nearest even, each cell).
template <int V, typename T>
__device__ __forceinline__ void ldv(const T* p, float (&out)[V]) {
  if constexpr (V == 1) {
    out[0] = ld(p);
  } else if constexpr (sizeof(T) == 4) {
    const float2 w = *reinterpret_cast<const float2*>(p);
    out[0] = w.x;
    out[1] = w.y;
  } else {
    const __nv_bfloat162 w = *reinterpret_cast<const __nv_bfloat162*>(p);
    out[0] = __low2float(w);
    out[1] = __high2float(w);
  }
}
template <int V, typename T>
__device__ __forceinline__ void stv(T* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    st(p, v[0]);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  }
}

// Copy of one word of V cells of T from device memory into a ring:
// cp.async (4 or 8 bytes), or, for a lone bf16 cell, an ordinary load
// and store (published by the same barrier).
template <int V, typename T>
__device__ __forceinline__ void copy_word(T* dst, const T* src) {
  constexpr int BYTES = V * static_cast<int>(sizeof(T));
  if constexpr (BYTES == 4 || BYTES == 8) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(BYTES)
                 : "memory");
  } else {
    *dst = *src;
  }
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared memory bytes rounded up to 16.
constexpr int round16(int b) { return (b + 15) / 16 * 16; }
