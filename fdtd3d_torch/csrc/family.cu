// Two-pass family update of the 3D Yee scheme, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// fdtd3d_tpu/ops/pallas3d.py::make_family_kernel (builder :167, kernel
// body :293, pallas_call :507) for 3D real float32 and bf16 storage,
// unsharded; the step around it is
// fdtd3d_torch/ops/pallas3d.py::make_pallas_step.
//
// What one launch computes, on per-component arrays (n1, n2, n3)
// float32 or bf16 (Grid.bf16: fields loaded as floats, computed in
// float32, rounded to bf16 where they are stored; psi, J and the
// coefficients float32), C order, z innermost (the reference's
// unpacked state):
//   E' = ca E + cb (curl_b H + y/z CPML deltas - J'),   J' = kj J + bj E
//   H' = da H - db (curl_f E + y/z CPML deltas + K'),   K' = km K + bm H
// (K: magnetic Drude, the reference's H-family ADE current,
// pallas3d.py:191), with PEC zero ghosts outside the domain, per-cell or scalar
// coefficients, and PEC walls on tangential E. Each curl term is
// s * dfa, plus, on a y or z CPML slab, s * ((ik - 1) dfa + psi') with
// psi' = b psi + c dfa on the compact slab psi (2m planes along the
// axis). The x axis is the reference's "post" axis: the kernel takes
// the pure x curl and ops/pallas3d.x_slab_post adds the x psi delta on
// the 2m boundary planes afterwards. TFSF and the point source are
// plane patches after the launch (ops/pallas3d.py).
//
// The per-cell arithmetic (curl terms with their slab psi, Drude J,
// the update and the walls) is csrc/family_cell.cuh, shared with the
// recompute-fused pass; this file supplies the curl's differences.
//
// Design: one thread per cell, z innermost (neighbouring threads touch
// neighbouring addresses), the x and y neighbours read through L1/L2.
// A cell's new values depend on its own old values (field, psi, J) and
// on the OTHER family's neighbours only, so the kernel is correct in
// place as well as out of place; the port calls it out of place (fresh
// outputs), so the step does not mutate its input state.
//
// Bound: memory bytes. A launch reads 6 field volumes (its own family
// and the other) and writes 3, so a step of two launches moves 18
// volumes (72 B/cell f32) plus the y/z psi slabs, and J or K read and
// written (24 B/cell each) where the family has one, against ~30 flops
// a cell per family: far below the H100's ~20 flops per byte.
//
// Offsets are computed in 64 bits. Every entry returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include "family_cell.cuh"

struct Params {
  FamOps f;                   // the family updated
  const void* S[3];           // the curl source family (float or bf16)
  Drude dr;                   // the family's ADE current: J (E) or K
                              // (H); null pointers without it
  Grid g;
};

// BACKWARD = true: E from backward differences of H (Drude J, walls);
// false: H from forward differences of E (magnetic Drude K). T: the
// fields' storage type.
template <bool BACKWARD, typename T>
__global__ void __launch_bounds__(128) family_pass(Params p) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= p.g.n[2]) return;
  const int idx[3] = {static_cast<int>(blockIdx.z),
                      static_cast<int>(blockIdx.y), k};
  const int64_t cell = cell_index(p.g, idx);
  const int64_t stride[3] = {static_cast<int64_t>(p.g.n[1]) * p.g.n[2],
                             p.g.n[2], 1};

#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float acc = curl_acc(p.f, p.g, c, idx, true, [&](int t) {
      const int a = term_axis(c, t);
      const T* src = fld<T>(p.S, term_comp(c, t)) + cell;
      if (BACKWARD) {
        const float prev = idx[a] > 0 ? ld(src - stride[a]) : 0.f;
        return (ld(src) - prev) * p.g.inv_dx;
      }
      const float next = idx[a] < p.g.n[a] - 1 ? ld(src + stride[a]) : 0.f;
      return (next - ld(src)) * p.g.inv_dx;
    });
    if (BACKWARD) {
      e_value<T>(p.f, p.dr, p.g, c, idx, cell, acc, true);
    } else {
      h_value<T>(p.f, p.dr, c, cell, ld(fld<T>(p.f.F, c) + cell), acc);
    }
  }
}

static int launch(const Params* p, void* stream, bool backward) {
  const dim3 block(128);
  if (p->g.n[0] > 65535 || p->g.n[1] > 65535) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const dim3 grid((p->g.n[2] + 127) / 128, p->g.n[1], p->g.n[0]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (backward && p->g.bf16) {
    family_pass<true, bf16_t><<<grid, block, 0, s>>>(*p);
  } else if (backward) {
    family_pass<true, float><<<grid, block, 0, s>>>(*p);
  } else if (p->g.bf16) {
    family_pass<false, bf16_t><<<grid, block, 0, s>>>(*p);
  } else {
    family_pass<false, float><<<grid, block, 0, s>>>(*p);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" {

int fdtd_params_size() { return static_cast<int>(sizeof(Params)); }

int fdtd_e_family(const Params* p, void* stream) {
  return launch(p, stream, true);
}

int fdtd_h_family(const Params* p, void* stream) {
  return launch(p, stream, false);
}

const char* fdtd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
