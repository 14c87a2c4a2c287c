// Packed leapfrog half-steps of the 3D Yee scheme, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// fdtd3d_tpu/ops/pallas_packed.py::make_packed_eh_step (kernel body at
// pallas_packed.py:694, pallas_call at :1138) for 3D real float32 and
// bf16 storage.
//
// What one step computes, on the reference's stacked layout
// E, H = (3, n1, n2, n3) float32 or bf16, C order, z innermost:
//   E' = ca E + cb (curl_b H + CPML terms - J'),   J' = kj J + bj E
//   H' = da H - db (curl_f E' + CPML terms + K'),  K' = km K + bm H
// with PEC zero ghosts outside the domain, the y/z/x CPML psi
// recursions on compact slab stacks, electric Drude J and magnetic
// Drude K (the family's ADE current, Params.J: J for the E launch, K
// for the H launch, with its coefficients in kj/bj), per-cell or
// scalar coefficients, and PEC walls on tangential E. TFSF and point
// sources are applied between the two launches as thin plane patches
// (fdtd3d_torch/ops/patches.py), in the order of the reference's plain
// step: E update, E patches, H update, H patches.
//
// Design. The TPU kernel runs H one x-tile behind E and carries the
// fresh E tile in VMEM scratch, which relies on the TPU grid running in
// order. CUDA blocks run in no order, so this twin uses two launches per
// step, fdtd_e_update then fdtd_h_update, each one thread per cell with
// z innermost (neighbouring threads touch neighbouring addresses), each
// updating its family in place: a cell's new value depends on its own
// old value and on the OTHER family's neighbours only, so no thread
// reads what another writes. The step is bound by memory bytes: each
// launch reads 6 field volumes and writes 3, so a step moves 18 volumes
// (72 B/cell) against the 12 (48 B/cell) a single fused pass needs. A
// single-launch fusion is later work.
//
// Scalars vs grids: each coefficient comes as a nullable grid pointer
// plus a scalar, so one build serves uniform media and material grids.
// Offsets are computed in 64 bits: at 1024^3 the stacked array holds
// more than 2^31 elements.
//
// Lanes (the port of make_packed_eh_step_batched, pallas_packed.py:537,
// whose pallas_call the reference vmaps over a lane-major grid
// dimension): one launch advances `lanes` independent scenarios of the
// same shape. The lane is folded into the grid's z dimension (lane =
// blockIdx.z / n1), and every base pointer steps by a 64-bit lane
// stride: the fields, J and psi by their per-lane extents, a
// coefficient grid by its own stride (0 for a grid shared by all lanes,
// n1 n2 n3 for a per-lane grid). Scalar coefficients are one value for
// every lane, as the reference bakes them. A solo run is lanes = 1.
//
// bf16 storage (Params.bf16): E and H are bf16 words, loaded as floats
// and rounded to bf16 where they are stored (csrc/storage.cuh); psi, J,
// the profiles and the coefficients stay float32, as does all the
// arithmetic. A launch then moves half the field bytes: each cell's new
// value is stored once, so the H launch reads the rounded E, as the
// plain version's in-place updates do.
//
// Compensated (Kahan) float32 (Params.R, the reference's
// pallas_packed.py:588-589, :757-759, :872-881 and :963-972): every
// difference is scaled by the double-single 1/dx (d0 inv_dx +
// d0 inv_dx_lo) and the update is
//   u = (a - 1) old +- b acc + (a_lo old +- b_lo acc),  y = u - r,
//   new = old + y,  r' = (new - old) - y
// with the bf16 residual r of the family (rE or rH, same layout as F)
// read and written in place, r' zeroed by the PEC walls with E. The
// coefficients are scalars in that mode (a grid sends the run to the
// plain step, as the reference's kernel declines it). That branch
// (COMP) does every product and sum with an explicitly rounded
// intrinsic (__fmul_rn, __fadd_rn, __fsub_rn) in the plain version's
// order: no FMA contraction, so r' is the true rounding error of the
// add and the launch reproduces the plain version's bits. The other
// builds keep their (contracted) arithmetic. It adds the residuals'
// 2 B x 3 components read and written to a launch's bytes.
//
// Every entry returns cudaGetLastError() so the caller can raise on a
// refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "storage.cuh"

struct Coef {
  const float* grid;  // (n1, n2, n3), (lanes, n1, n2, n3) or nullptr
  long long lane;     // lane stride of grid: 0 (shared) or n1 n2 n3
  float val;          // used when grid is nullptr
};

struct Params {
  void* F;               // family being updated, (lanes, 3, n1, n2, n3)
  const void* S;         // curl source family, (lanes, 3, n1, n2, n3)
  float* J;              // the family's ADE current (lanes, 3, n1, n2, n3):
                         // Drude J (E) or K (H); or nullptr
  bf16_t* R;             // Kahan residuals (lanes, 3, n1, n2, n3) bf16, or
                         // nullptr (not compensated)
  float* psi[3];         // per axis a: (lanes, 2, n with dim a = 2 m[a])
                         // or nullptr
  const float* prof[3];  // per axis a: (3, 2 m[a]) rows b, c, 1/kappa
  long long field_lane;  // lane stride of F, S and J: 3 n1 n2 n3
  long long psi_lane[3];  // lane stride of psi[a]
  int m[3];              // slab planes per side, 0 = no CPML on the axis
  Coef a[3];             // ca (E) / da (H)
  Coef b[3];             // cb (E) / db (H)
  Coef kj[3];            // ADE current: kj, bj (E) or km, bm (H)
  Coef bj[3];
  float a_lo[3];         // compensated: low words of the scalar a, b
  float b_lo[3];
  int n1, n2, n3;
  int lanes;             // scenarios advanced by one launch
  float inv_dx;
  float inv_dx_lo;       // compensated: low word of 1/dx
  int bf16;              // F and S are bf16 words (else float32)
};

// Products and sums of the compensated branch: rounded to nearest one by
// one, never contracted into an FMA.
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}

// CURL_TERMS of fdtd3d_tpu/layout.py: component c couples
// (derivative axis, source component, sign) = ((c+1)%3, (c+2)%3, +1)
// and ((c+2)%3, (c+1)%3, -1). Written as functions of compile-time
// indices so the unrolled loops below fold them into constants.
__device__ __forceinline__ constexpr int term_axis(int c, int t) {
  return (c + 1 + t) % 3;
}
__device__ __forceinline__ constexpr int term_comp(int c, int t) {
  return (c + 2 - t) % 3;
}

__device__ __forceinline__ float coef(const Coef& c, int lane,
                                      int64_t cell) {
  return c.grid ? c.grid[lane * c.lane + cell] : c.val;
}

// Offset of cell (i, j, k) in the psi stack of axis a, row `row`, at
// slab plane q (the index along axis a inside the compact 2m planes).
__device__ __forceinline__ int64_t psi_offset(int a, int row, int q, int i,
                                              int j, int k, int64_t n1,
                                              int64_t n2, int64_t n3,
                                              int64_t m2) {
  if (a == 0) return ((row * m2 + q) * n2 + j) * n3 + k;
  if (a == 1) return ((row * n1 + i) * m2 + q) * n3 + k;
  return ((row * n1 + i) * n2 + j) * m2 + q;
}

// One family update. BACKWARD = true: E from backward differences of H
// (with Drude J and PEC walls); false: H from forward differences of E
// (with magnetic Drude K). MULTI = false is a single-lane launch: the
// lane is the constant 0. COMP: compensated mode (float fields only).
// T: the fields' storage type (float or bf16).
template <bool BACKWARD, bool MULTI, bool COMP, typename T>
__global__ void __launch_bounds__(128) family_update(Params p) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y;
  const int i = MULTI ? blockIdx.z % p.n1 : blockIdx.z;
  const int lane = MULTI ? blockIdx.z / p.n1 : 0;
  if (k >= p.n3) return;
  T* const F = static_cast<T*>(p.F) + lane * p.field_lane;
  const T* const S = static_cast<const T*>(p.S) + lane * p.field_lane;
  float* const J = p.J ? p.J + lane * p.field_lane : nullptr;
  const int64_t n1 = p.n1, n2 = p.n2, n3 = p.n3;
  const int64_t vol = n1 * n2 * n3;
  const int64_t cell = (i * n2 + j) * n3 + k;
  const int64_t stride[3] = {n2 * n3, n3, 1};
  const int idx[3] = {i, j, k};
  const int n[3] = {p.n1, p.n2, p.n3};

#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int a = term_axis(c, t);
      const float s = t == 0 ? 1.f : -1.f;
      const T* src = S + term_comp(c, t) * vol + cell;
      float d0;
      if (BACKWARD) {
        const float prev = idx[a] > 0 ? ld(src - stride[a]) : 0.f;
        d0 = ld(src) - prev;
      } else {
        const float next = idx[a] < n[a] - 1 ? ld(src + stride[a]) : 0.f;
        d0 = next - ld(src);
      }
      const float dfa = COMP ? add_rn(mul_rn(d0, p.inv_dx),
                                      mul_rn(d0, p.inv_dx_lo))
                             : d0 * p.inv_dx;
      const int m = p.m[a];
      if (m > 0) {
        const int ia = idx[a];
        const int q = ia < m ? ia : (ia >= n[a] - m ? ia - (n[a] - 2 * m)
                                                    : -1);
        if (q >= 0) {
          const int row = c < a ? c : c - 1;
          const int64_t off =
              psi_offset(a, row, q, i, j, k, n1, n2, n3, 2 * m);
          const float* pr = p.prof[a];
          float* ps = p.psi[a] + lane * p.psi_lane[a] + off;
          if (COMP) {
            const float psi = add_rn(mul_rn(pr[q], *ps),
                                     mul_rn(pr[2 * m + q], dfa));
            *ps = psi;
            acc = add_rn(acc, mul_rn(s, add_rn(mul_rn(sub_rn(pr[4 * m + q],
                                                             1.f),
                                                      dfa),
                                               psi)));
          } else {
            const float psi = pr[q] * *ps + pr[2 * m + q] * dfa;
            *ps = psi;
            acc += s * ((pr[4 * m + q] - 1.f) * dfa + psi);
          }
        }
      }
      acc = COMP ? add_rn(acc, mul_rn(s, dfa)) : acc + s * dfa;
    }
    T* f = F + c * vol + cell;
    const float old = ld(f);
    if (J) {  // the ADE current: J' taken off E's acc, K' added to H's
      float* jp = J + c * vol + cell;
      const float ka = coef(p.kj[c], lane, cell);
      const float kb = coef(p.bj[c], lane, cell);
      const float jn = COMP ? add_rn(mul_rn(ka, *jp), mul_rn(kb, old))
                            : ka * *jp + kb * old;
      *jp = jn;
      if (COMP) {
        acc = BACKWARD ? sub_rn(acc, jn) : add_rn(acc, jn);
      } else {
        acc = BACKWARD ? acc - jn : acc + jn;
      }
    }
    const float ca = coef(p.a[c], lane, cell);
    const float cb = coef(p.b[c], lane, cell);
    float v, r = 0.f;
    if (COMP) {
      // Kahan: new = old + y, y = u - r, with the stored residual r
      bf16_t* rp = p.R + lane * p.field_lane + c * vol + cell;
      const float am1 = mul_rn(sub_rn(ca, 1.f), old);
      const float lo_a = mul_rn(p.a_lo[c], old);
      const float u =
          BACKWARD ? add_rn(add_rn(am1, mul_rn(cb, acc)),
                            add_rn(lo_a, mul_rn(p.b_lo[c], acc)))
                   : add_rn(sub_rn(am1, mul_rn(cb, acc)),
                            sub_rn(lo_a, mul_rn(p.b_lo[c], acc)));
      const float y = sub_rn(u, ld(rp));
      v = add_rn(old, y);
      r = sub_rn(sub_rn(v, old), y);
      if (BACKWARD) {
#pragma unroll
        for (int w = 0; w < 3; ++w) {
          if (w != c && (idx[w] == 0 || idx[w] == n[w] - 1)) r = 0.f;
        }
      }
      st(rp, r);
    } else if (BACKWARD) {
      v = ca * old + cb * acc;
    } else {
      v = ca * old - cb * acc;
    }
    if (BACKWARD) {
      // PEC walls: tangential E vanishes on the walls of the two axes
      // other than its own.
#pragma unroll
      for (int w = 0; w < 3; ++w) {
        if (w != c && (idx[w] == 0 || idx[w] == n[w] - 1)) v = 0.f;
      }
    }
    st(f, v);
  }
}

template <bool COMP, typename T>
static void launch_t(const Params* p, dim3 grid, dim3 block, cudaStream_t s,
                     bool backward) {
  const bool multi = p->lanes > 1;
  if (backward && multi) {
    family_update<true, true, COMP, T><<<grid, block, 0, s>>>(*p);
  } else if (backward) {
    family_update<true, false, COMP, T><<<grid, block, 0, s>>>(*p);
  } else if (multi) {
    family_update<false, true, COMP, T><<<grid, block, 0, s>>>(*p);
  } else {
    family_update<false, false, COMP, T><<<grid, block, 0, s>>>(*p);
  }
}

static int launch(const Params* p, void* stream, bool backward) {
  const dim3 block(128);
  // the lane rides the z dimension of the grid, beside the x index
  if (p->lanes < 1 || (long long)p->n1 * p->lanes > 65535) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const dim3 grid((p->n3 + 127) / 128, p->n2, p->n1 * p->lanes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->R && p->bf16) {  // compensated mode is float32 only
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (p->R) {
    launch_t<true, float>(p, grid, block, s, backward);
  } else if (p->bf16) {
    launch_t<false, bf16_t>(p, grid, block, s, backward);
  } else {
    launch_t<false, float>(p, grid, block, s, backward);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" {

int fdtd_params_size() { return static_cast<int>(sizeof(Params)); }

int fdtd_e_update(const Params* p, void* stream) {
  return launch(p, stream, true);
}

int fdtd_h_update(const Params* p, void* stream) {
  return launch(p, stream, false);
}

const char* fdtd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
