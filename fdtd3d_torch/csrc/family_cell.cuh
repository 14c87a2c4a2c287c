// Per-cell arithmetic of one field family's update for the two-pass
// kernels (csrc/family.cu), with the parameter blocks (mirrored in
// ctypes by fdtd3d_torch/ops/pallas3d.py) and index helpers that the
// recompute-fused pass (csrc/fused_eh.cu) fills and uses too; the fused
// pass has its own per-cell code (every axis's psi, records, point
// source).
//
// Arrays are per component (n1, n2, n3), C order, z innermost: the
// fields float32 or bf16 (Grid.bf16; csrc/storage.cuh), everything else
// float32.
// A curl term of component c is s * dfa, plus, on a y or z CPML slab,
// s * ((ik - 1) dfa + psi') with psi' = b psi + c dfa on the compact
// slab psi (2m planes along the axis). x is the reference's "post"
// axis: its psi delta is added after the launch
// (ops/pallas3d.x_slab_post), so no x term carries psi here.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "storage.cuh"

struct Coef {
  const float* grid;  // (n1, n2, n3) or nullptr
  float val;          // used when grid is nullptr
};

// One family's operands.
struct FamOps {
  const void* F[3];           // old components (float or bf16 words)
  void* out[3];               // new components (float or bf16 words)
  const float* psi_in[3][2];  // per component, per curl term: the
  float* psi_out[3][2];       // compact slab psi of a y/z CPML axis, or
                              // nullptr (no in-kernel psi on that term)
  const float* prof[3];       // per axis a: (3, 2 m[a]) rows b, c, 1/kappa
  Coef a[3];                  // ca (E) / da (H)
  Coef b[3];                  // cb (E) / db (H)
};

// A family's ADE current, or null pointers: electric Drude J' = kj J +
// bj E on the E family, magnetic Drude K' = km K + bm H on the H family
// (its coefficients in kj, bj).
struct Drude {
  const float* Jin[3];
  float* Jout[3];
  Coef kj[3];
  Coef bj[3];
};

struct Grid {
  int m[3];      // slab planes per side of the y/z CPML axes; m[0] = 0
  int n[3];      // n1, n2, n3
  float inv_dx;
  int bf16;      // the fields are bf16 words (else float32)
};

// Component c of a family's fields as words of the storage type T.
template <typename T>
__device__ __forceinline__ const T* fld(const void* const (&F)[3], int c) {
  return static_cast<const T*>(F[c]);
}
template <typename T>
__device__ __forceinline__ T* fld(void* const (&F)[3], int c) {
  return static_cast<T*>(F[c]);
}

// CURL_TERMS of fdtd3d_torch/layout.py: component c couples
// (derivative axis, source component, sign) = ((c+1)%3, (c+2)%3, +1)
// and ((c+2)%3, (c+1)%3, -1).
__device__ __forceinline__ constexpr int term_axis(int c, int t) {
  return (c + 1 + t) % 3;
}
__device__ __forceinline__ constexpr int term_comp(int c, int t) {
  return (c + 2 - t) % 3;
}

__device__ __forceinline__ float coef(const Coef& c, int64_t cell) {
  return c.grid ? c.grid[cell] : c.val;
}

__device__ __forceinline__ int64_t cell_index(const Grid& g,
                                              const int idx[3]) {
  return (static_cast<int64_t>(idx[0]) * g.n[1] + idx[1]) * g.n[2] + idx[2];
}

// Slab plane of index ia on an axis of n cells with m planes a side, or
// -1 outside the two slabs.
__device__ __forceinline__ int slab_plane(int ia, int n, int m) {
  return ia < m ? ia : (ia >= n - m ? ia - (n - 2 * m) : -1);
}

// Index of cell idx in the compact slab psi of axis a (1 or 2) at slab
// plane q.
__device__ __forceinline__ int64_t psi_index(const Grid& g, int a, int q,
                                             const int idx[3]) {
  const int64_t m2 = 2 * g.m[a];
  if (a == 1) return (static_cast<int64_t>(idx[0]) * m2 + q) * g.n[2] + idx[2];
  return (static_cast<int64_t>(idx[0]) * g.n[1] + idx[1]) * m2 + q;
}

// Curl accumulator of component c at cell idx: its two terms from
// diff(t), term t's difference along term_axis(c, t) already over dx,
// each with its slab psi recursion where the family has one. The new
// psi is written when `write`.
template <class Diff>
__device__ __forceinline__ float curl_acc(const FamOps& f, const Grid& g,
                                          int c, const int idx[3],
                                          bool write, Diff diff) {
  float acc = 0.f;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int a = term_axis(c, t);
    const float s = t == 0 ? 1.f : -1.f;
    const float dfa = diff(t);
    float term = s * dfa;
    const float* pin = f.psi_in[c][t];
    if (pin != nullptr) {
      const int m = g.m[a];
      const int q = slab_plane(idx[a], g.n[a], m);
      if (q >= 0) {
        const int64_t off = psi_index(g, a, q, idx);
        const float* pr = f.prof[a];
        const float psi = pr[q] * pin[off] + pr[2 * m + q] * dfa;
        if (write) f.psi_out[c][t][off] = psi;
        term = term + s * ((pr[4 * m + q] - 1.f) * dfa + psi);
      }
    }
    acc = t == 0 ? term : acc + term;
  }
  return acc;
}

// New E component c at cell idx from its curl accumulator: the Drude
// current taken off, ca E + cb acc, and the PEC walls (tangential E
// vanishes on the walls of the two axes other than its own). J' and E'
// are written when `write`. T: the fields' storage type.
template <typename T>
__device__ __forceinline__ float e_value(const FamOps& e, const Drude& dr,
                                         const Grid& g, int c,
                                         const int idx[3], int64_t cell,
                                         float acc, bool write) {
  const float old = ld(fld<T>(e.F, c) + cell);
  if (dr.Jin[c] != nullptr) {
    const float jn = coef(dr.kj[c], cell) * dr.Jin[c][cell] +
                     coef(dr.bj[c], cell) * old;
    if (write) dr.Jout[c][cell] = jn;
    acc = acc - jn;
  }
  float v = coef(e.a[c], cell) * old + coef(e.b[c], cell) * acc;
#pragma unroll
  for (int w = 0; w < 3; ++w) {
    if (w != c && (idx[w] == 0 || idx[w] == g.n[w] - 1)) v = 0.f;
  }
  if (write) st(fld<T>(e.out, c) + cell, v);
  return v;
}

// New H component c at `cell` from its curl accumulator: the magnetic
// Drude current K' (`dk`, null pointers without it) added (the dual of
// J's sign on E), then da H - db acc. K' and H' are written.
template <typename T>
__device__ __forceinline__ void h_value(const FamOps& h, const Drude& dk,
                                        int c, int64_t cell, float old,
                                        float acc) {
  if (dk.Jin[c] != nullptr) {
    const float kn = coef(dk.kj[c], cell) * dk.Jin[c][cell] +
                     coef(dk.bj[c], cell) * old;
    dk.Jout[c][cell] = kn;
    acc = acc + kn;
  }
  st(fld<T>(h.out, c) + cell,
     coef(h.a[c], cell) * old - coef(h.b[c], cell) * acc);
}
