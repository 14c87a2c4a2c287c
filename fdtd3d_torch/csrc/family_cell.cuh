// Per-cell arithmetic of one field family's update for the two-pass
// kernels (csrc/family.cu), with the parameter blocks (mirrored in
// ctypes by fdtd3d_torch/ops/pallas3d.py), index helpers and the TFSF
// record table that the recompute-fused pass (csrc/fused_eh.cu) fills
// and uses too; the fused pass has its own per-cell code.
//
// Arrays are per component (n1, n2, n3), C order, z innermost: the
// fields float32 or bf16 (Grid.bf16; csrc/storage.cuh), everything else
// float32.
// A curl term of component c is s * dfa, plus, on a CPML slab of its
// axis (x, y or z alike), s * ((ik - 1) dfa + psi') with
// psi' = b psi + c dfa on the compact slab psi (2m planes along the
// axis). Every helper below does the plain version's operations
// (fdtd3d_torch/ops/pallas3d.py::_family_plain) in its order, so a
// library built without FMA contraction reproduces its bits.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "storage.cuh"

struct Coef {
  const float* grid;  // (n1, n2, n3) or nullptr
  float val;          // used when grid is nullptr, and by the items
                      // outside the grids' box: the grid's background
};

// One family's operands.
struct FamOps {
  const void* F[3];           // old components (float or bf16 words)
  void* out[3];               // new components (float or bf16 words)
  const float* psi_in[3][2];  // per component, per curl term: the
  float* psi_out[3][2];       // compact slab psi of a CPML axis, or
                              // nullptr (no CPML on that term's axis)
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
  int m[3];      // slab planes per side of each CPML axis (0: none)
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

// Slab plane of index ia on an axis of n cells with m planes a side, or
// -1 outside the two slabs (always with m = 0).
__device__ __forceinline__ int slab_plane(int ia, int n, int m) {
  return ia < m ? ia : (ia >= n - m ? ia - (n - 2 * m) : -1);
}

// Offset of cell (i, j, k) in the compact slab psi of axis a at slab
// plane q: (2m, n2, n3), (n1, 2m, n3) or (n1, n2, 2m) (m2 = 2m).
__device__ __forceinline__ int64_t slab_offset(int a, int q, int i, int j,
                                               int k, int n2, int n3,
                                               int m2) {
  if (a == 0) return (static_cast<int64_t>(q) * n2 + j) * n3 + k;
  if (a == 1) return (static_cast<int64_t>(i) * m2 + q) * n3 + k;
  return (static_cast<int64_t>(i) * n2 + j) * m2 + q;
}

// Curl term t of a component (sign + for t = 0, - for t = 1) from its
// difference over dx, dfa. With q >= 0 (the cell lies on slab plane q
// of the term's axis) the CPML recursion psi' = b psi + c dfa on the
// compact slab psi at `off` (read from pin, written to pout; profile
// rows pr of m2 = 2m values each) and its correction are added.
__device__ __forceinline__ float curl_term(int t, float dfa, int q,
                                           const float* pr, int m2,
                                           const float* pin, float* pout,
                                           int64_t off) {
  float term = t == 0 ? dfa : -dfa;
  if (q >= 0) {
    const float psi = pr[q] * pin[off] + pr[m2 + q] * dfa;
    pout[off] = psi;
    const float fix = (pr[2 * m2 + q] - 1.f) * dfa + psi;
    term = term + (t == 0 ? fix : -fix);
  }
  return term;
}

// A component's new value from its curl accumulator `acc` (records
// already in): the ADE current jn (J' taken off E's acc, BACKWARD; K'
// added to H's; `ade` whether the family has one), then, where `pcell`
// (the point source's cell and component, E only), the source's
// `drive`; then a old + b acc (E) or a old - b acc (H), and for E the
// PEC walls (`wall`) last, so nothing added on a wall cell survives.
template <bool BACKWARD>
__device__ __forceinline__ float new_value(float old, float acc, float a,
                                           float b, bool ade, float jn,
                                           bool pcell, float drive,
                                           bool wall) {
  if (ade) acc = BACKWARD ? acc - jn : acc + jn;
  if (BACKWARD && pcell) acc = acc + drive;
  if (BACKWARD) return wall ? 0.f : a * old + b * acc;
  return a * old - b * acc;
}

// TFSF records (csrc/family.cu, csrc/fused_eh.cu): each adds its plane
// term (ops/tfsf.py::record_terms' vector) to one component's
// accumulator on one plane.
#define MAX_REC 16  // records of a family; mirrors ops/pallas3d.py

struct Rec {
  int off;    // offset of the record's plane cells in the terms vector
  int comp;   // component index within the family
  int axis;   // normal axis of the plane
  int plane;  // index of the plane along `axis`
};

// A family's record table in shared memory (a kernel copies it from its
// parameter block once: indexing the parameter block with a runtime
// index is slow), with the bits of each component's records and of the
// x-normal records.
struct RecTable {
  int comp[MAX_REC];
  int axis[MAX_REC];
  int plane[MAX_REC];
  int off[MAX_REC];
  unsigned cbits[3];
  unsigned xbits;
};

// The n records `rec` into `rt`, by the block's threads (`tid`).
__device__ __forceinline__ void copy_table(const Rec* rec, int n, int tid,
                                           RecTable& rt) {
  if (tid < n) {
    rt.comp[tid] = rec[tid].comp;
    rt.axis[tid] = rec[tid].axis;
    rt.plane[tid] = rec[tid].plane;
    rt.off[tid] = rec[tid].off;
  }
  if (tid == 0) {
    unsigned cb0 = 0u, cb1 = 0u, cb2 = 0u, xb = 0u;
#pragma unroll
    for (int r = 0; r < MAX_REC; ++r) {
      if (r < n) {
        const unsigned bit = 1u << r;
        const int c = rec[r].comp;
        cb0 |= c == 0 ? bit : 0u;
        cb1 |= c == 1 ? bit : 0u;
        cb2 |= c == 2 ? bit : 0u;
        xb |= rec[r].axis == 0 ? bit : 0u;
      }
    }
    rt.cbits[0] = cb0;
    rt.cbits[1] = cb1;
    rt.cbits[2] = cb2;
    rt.xbits = xb;
  }
}

// The y- and z-normal records whose plane holds column (j, k).
__device__ __forceinline__ unsigned column_bits(const RecTable& rt, int n,
                                                int j, int k) {
  unsigned bits = 0u;
  for (int r = 0; r < n; ++r) {
    const int a = rt.axis[r];
    if (a != 0 && (a == 1 ? j : k) == rt.plane[r]) bits |= 1u << r;
  }
  return bits;
}

// The x-normal records on plane x (the same for every thread).
__device__ __forceinline__ unsigned plane_bits(const RecTable& rt, int x) {
  unsigned bits = 0u;
  for (unsigned z = rt.xbits; z; z &= z - 1) {
    const int r = __ffs(z) - 1;
    bits |= rt.plane[r] == x ? 1u << r : 0u;
  }
  return bits;
}

// Index of cell (i, j, k) inside the plane of a record whose normal is
// `axis` (C order over the two other axes).
__device__ __forceinline__ int plane_index(int axis, int i, int j, int k,
                                           int n2, int n3) {
  if (axis == 0) return j * n3 + k;
  if (axis == 1) return i * n3 + k;
  return i * n2 + j;
}
