// Recompute-fused single pass (E then H) of the 3D Yee scheme, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// fdtd3d_tpu/ops/pallas_fused.py::make_fused_eh_step (builder :310,
// kernel body :423, pallas_call :709) for 3D real float32, unsharded;
// the step around it is fdtd3d_torch/ops/pallas_fused.py.
//
// What one launch computes, on per-component arrays (n1, n2, n3)
// float32, C order, z innermost (the reference's unpacked state):
//   E' = ca E + cb (curl_b H + y/z CPML deltas - J'),   J' = kj J + bj E
//   H' = da H - db (curl_f E' + y/z CPML deltas)
// the arithmetic of csrc/family.cu's two launches, from the same
// per-cell functions (csrc/family_cell.cuh): PEC zero ghosts,
// per-cell or scalar coefficients, PEC walls on tangential E, the y/z
// slab psi recursions in-kernel and the pure curl on x (the x psi delta
// is a post-pass). H is computed from the pre-patch E': the step adds
// the curl of the post-kernel E patches (x slab, TFSF, point source)
// to H afterwards (pallas_fused.apply_patch_h_corrections).
//
// Design. The TPU kernel tiles x into slabs of the full (y, z) extent
// and recomputes one redundant E plane per tile, so a tile's H never
// waits on the next tile. Here a block owns a TX x TY x TZ brick (16 x 8
// x 32 cells) and marches x over its TX planes. Its 297 threads are the
// brick's (TY+1) x (TZ+1) E face: one y row and one z column more than
// it owns. For each plane every thread computes new E at its face cell
// into a two-plane ring in shared memory; then the 256 threads inside
// the brick compute new H on the plane from E' at this plane and the
// next. The redundant E cells (the next x plane, the extra row and
// column) are computed from the same inputs as their owners compute
// them and are not written, so no block depends on another and blocks
// may run in any order. Cells beyond the domain hold E' = 0, the PEC
// ghost of H's forward differences. The old H a thread reads at its
// cell for E (the three components) is the old H its H update needs
// and the back neighbour of the next plane's x differences, so it is
// carried in registers from plane to plane. The launch bounds ask for
// four blocks an SM (48 registers a thread, 16 bytes of spills):
// measured the fastest of the bricks and bounds
// scripts/fused_variants.py tries.
//
// Out of place, necessarily: the redundant E cells read old E, psi_E,
// J and old H on cells a neighbouring block owns, and E's backward
// differences read old H one cell behind the brick, so a block must
// never overwrite what another may still read. Every output (E', H',
// psi_E', psi_H', J') goes to a fresh array; the caller keeps the state
// it passed.
//
// Bound: memory bytes. The launch reads E, H (and J) and writes E', H'
// (and J'): 12 field volumes (48 B/cell f32) plus psi, against the
// two-pass step's 18. The redundant E work is (TX+1)(TY+1)(TZ+1) /
// (TX TY TZ) = 1.23x the owned E cells; its extra reads mostly hit L2,
// where the neighbouring bricks read the same cells.
//
// Offsets are computed in 64 bits. Every entry returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include "family_cell.cuh"

struct Params {
  FamOps e;
  FamOps h;
  Drude dr;                   // null pointers without Drude J
  Grid g;
};

constexpr int TX = 16;  // x planes a block marches over
constexpr int TY = 8;   // owned y rows
constexpr int TZ = 32;  // owned z columns
constexpr int EY = TY + 1;  // the E face: one y row and one z column
constexpr int EZ = TZ + 1;  // more than the brick owns
constexpr int THREADS = EY * EZ;

// New E at (i, j, k), inside the domain, into es[c]. hp: old H at
// (i - 1, j, k) (the x differences' back neighbour, carried from the
// previous plane); hh receives old H at (i, j, k). psi_E', J' and E' are
// written when the cell is owned.
__device__ __forceinline__ void e_cell(const Params& p, int i, int j, int k,
                                       bool owned, const float hp[3],
                                       float hh[3], float* es0, float* es1,
                                       float* es2) {
  const int idx[3] = {i, j, k};
  const int64_t cell = cell_index(p.g, idx);
  const int64_t stride[3] = {static_cast<int64_t>(p.g.n[1]) * p.g.n[2],
                             p.g.n[2], 1};
#pragma unroll
  for (int d = 0; d < 3; ++d) hh[d] = p.h.F[d][cell];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float acc = curl_acc(p.e, p.g, c, idx, owned, [&](int t) {
      const int a = term_axis(c, t);
      const int d = term_comp(c, t);
      const float prev = a == 0 ? hp[d]
                         : idx[a] > 0 ? p.h.F[d][cell - stride[a]] : 0.f;
      return (hh[d] - prev) * p.g.inv_dx;
    });
    const float v = e_value(p.e, p.dr, p.g, c, idx, cell, acc, owned);
    (c == 0 ? *es0 : c == 1 ? *es1 : *es2) = v;
  }
}

// One thread per cell of the E face: thread (tz, ty) computes E at
// (y0 + ty, z0 + tz) on every plane the block visits, and, when it lies
// in the brick (tz < TZ, ty < TY), H at the same (y, z).
__global__ void __launch_bounds__(THREADS, 4) fused_eh(Params p) {
  __shared__ float ring[2][3][EY][EZ];
  const int tz = threadIdx.x, ty = threadIdx.y;
  const int z0 = blockIdx.x * TZ, y0 = blockIdx.y * TY, x0 = blockIdx.z * TX;
  const int n1 = p.g.n[0];
  const int x1 = min(x0 + TX, n1);
  const int j = y0 + ty, k = z0 + tz;
  const bool inside = j < p.g.n[1] && k < p.g.n[2];
  const bool brick = inside && ty < TY && tz < TZ;
  // held across the march: computing the H cell from them, not from
  // cell_index, leaves ptxas fewer spills at 48 registers (2.3% faster
  // at 256^3, scripts/fused_variants.py)
  const int64_t n2 = p.g.n[1], n3 = p.g.n[2];

  // old H at (plane - 1, j, k) and at (plane, j, k) of the E face cell
  float hp[3] = {0.f, 0.f, 0.f}, hc[3] = {0.f, 0.f, 0.f};
  if (inside && x0 > 0) {
    const int back[3] = {x0 - 1, j, k};
    const int64_t cell = cell_index(p.g, back);
#pragma unroll
    for (int d = 0; d < 3; ++d) hp[d] = p.h.F[d][cell];
  }
  {
    float* es = &ring[x0 & 1][0][ty][tz];
    float* es1 = &ring[x0 & 1][1][ty][tz];
    float* es2 = &ring[x0 & 1][2][ty][tz];
    *es = *es1 = *es2 = 0.f;
    if (inside) e_cell(p, x0, j, k, brick, hp, hc, es, es1, es2);
  }
  for (int i = x0; i < x1; ++i) {
    const int ip = i + 1;
    const int slot = ip & 1;
    float hn[3] = {0.f, 0.f, 0.f};
    ring[slot][0][ty][tz] = ring[slot][1][ty][tz] = ring[slot][2][ty][tz] =
        0.f;
    if (inside && ip < n1) {
      e_cell(p, ip, j, k, brick && ip < x1, hc, hn, &ring[slot][0][ty][tz],
             &ring[slot][1][ty][tz], &ring[slot][2][ty][tz]);
    }
    __syncthreads();
    if (brick) {
      float (*cur)[EY][EZ] = ring[i & 1];
      float (*nxt)[EY][EZ] = ring[slot];
      const int64_t cell = (i * n2 + j) * n3 + k;
      const int idx[3] = {i, j, k};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float acc = curl_acc(p.h, p.g, c, idx, true, [&](int t) {
          const int a = term_axis(c, t);
          const int d = term_comp(c, t);
          const float here = cur[d][ty][tz];
          const float next = a == 0 ? nxt[d][ty][tz]
                             : a == 1 ? cur[d][ty + 1][tz]
                                      : cur[d][ty][tz + 1];
          return (next - here) * p.g.inv_dx;
        });
        // hc holds old H at (i, j, k), loaded by this plane's E update
        h_value(p.h, c, cell, hc[c], acc);
      }
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) hc[d] = hn[d];
    __syncthreads();
  }
}

extern "C" {

int fdtd_params_size() { return static_cast<int>(sizeof(Params)); }

int fdtd_fused_eh(const Params* p, void* stream) {
  const dim3 block(EZ, EY);
  const dim3 grid((p->g.n[2] + TZ - 1) / TZ, (p->g.n[1] + TY - 1) / TY,
                  (p->g.n[0] + TX - 1) / TX);
  if (grid.y > 65535 || grid.z > 65535) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  fused_eh<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(*p);
  return static_cast<int>(cudaGetLastError());
}

const char* fdtd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
