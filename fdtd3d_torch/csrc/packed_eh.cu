// Packed leapfrog half-steps of the 3D Yee scheme, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// fdtd3d_tpu/ops/pallas_packed.py::make_packed_eh_step (kernel body at
// pallas_packed.py:694, pallas_call at :1138) and its lane-capable build
// make_packed_eh_step_batched (:537) for 3D real float32 and bf16
// storage.
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
// Two launches, each in place. The TPU kernel runs H one x-tile behind
// E in one pass, which relies on its grid running in order. A single
// CUDA pass would need a wavefront across blocks or a spare copy of E,
// H, J and K to recompute halos out of place, so a step stays two
// launches, fdtd_e_update then fdtd_h_update, each updating its family
// in place: a cell's new value depends only on its own old value and on
// the OTHER family, so no thread reads what another writes.
//
// The march. A thread block owns one work item of the host's plan
// (ops/packed.py::plan_items): a (y, z) tile of at most TY rows by TZ =
// 32 V columns (V = 2 cells a thread where the build takes pairs, else
// 1), the z cuts at multiples of TZ so that every owned row is whole
// aligned 128-byte lines (256 bytes for float pairs), over an x segment
// [x0, x1) of one lane. Warp w owns row j0 + w, lane l the V cells
// k0 + l V ... of it. The block marches x (E upwards, H downwards) and
// at each plane:
// - the source family's plane (H for E, E for H) lands in a shared
//   memory ring of SLOTS planes, brought by cp.async PIPE planes ahead
//   of the march (one word of V cells a thread and component: 4 bytes,
//   or 8 for float pairs): the tile, a 1-cell halo row (E: the row
//   below, H: the row above; components 0 and 2, by warp 0) and a
//   1-cell halo column (E: the word left of the tile, H: the word right
//   of it; components 0 and 1, by the last warp). Ring cells outside
//   the domain are zeroed once and never loaded: they are the PEC
//   ghosts. So the source family is read once an item, and a cell
//   issues 3 source requests where one thread a cell issued 12;
// - the y and z neighbours come from the ring, the x neighbour (the
//   plane before in the march: E reads H(i-1), H reads E(i+1)) from the
//   two components a thread kept in registers from the plane before
//   (components 1 and 2 have the x terms); marching H downwards makes
//   its x neighbour the plane before, as E's is;
// - the family being updated, J or K and the residuals come through
//   the thread's own slots of rings of the same depth, and are written
//   once each, in V-cell words, by the thread that owns the cell, as
//   psi is read and written;
// - one barrier a plane: it publishes the plane that landed and
//   retires the slot the next cp.async refills.
//
// Coefficient grids are read only by the items whose cells reach the
// box outside which every grid of the family holds its background
// value (plan flag GRID; ops/packed.py::material); the other items take
// the background from the scalar of the Coef (a uniform branch a
// block). J and K are read and written everywhere.
//
// Sections. The plan puts the items with a cell in a CPML slab of any
// axis (flag SLAB) first; they run the kernel with the psi path
// compiled in, the others one without it, started on the SMs the first
// leaves free (programmatic dependent launch: the two write disjoint
// cells and read only the other family). SECTIONS=0 runs every item in
// the slab kernel.
//
// bf16 storage (Params.bf16): E and H are bf16 words, loaded as floats
// and rounded to bf16 where they are stored (csrc/storage.cuh); psi, J,
// the profiles and the coefficients stay float32, as does all the
// arithmetic. A thread takes two z cells (a bf16x2 word), so every field
// request is 4 bytes and a warp moves 128 bytes a request, as in f32.
// The ring holds the bf16 words as they arrive (cp.async cannot widen);
// they are widened where they are read. Each new value is rounded once,
// where it is stored, so the H launch reads the rounded E, as the plain
// version's in-place updates do. An odd n3 leaves rows unaligned for
// words of two cells: that run takes one cell a thread, and its 2-byte
// ring words are copied by ordinary loads (cp.async copies 4 bytes at
// least).
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
// plain step, as the reference's kernel declines it). That build (COMP)
// does every product and sum with an explicitly rounded intrinsic
// (__fmul_rn, __fadd_rn, __fsub_rn) in the plain version's order: no
// FMA contraction, so r' is the true rounding error of the add and the
// launch reproduces the plain version's bits. It takes two cells a
// thread where n3 is even, so its residual words are 4 bytes too. The
// other builds contract the update's products (ca old + cb acc, the ADE
// current) into FMAs, but round each scaled difference d0 inv_dx on its
// own: the slab kernel keeps it for psi, so a contracted acc += d0 inv_dx
// in the plain kernel alone would give a cell other bits there than in
// the slab kernel, which a shard's identity slab planes run.
//
// Lanes: one launch advances `lanes` independent scenarios of the same
// shape; the lane is a column of the plan's row, and every base pointer
// steps by a 64-bit lane stride: the fields, J and R by 3 n1 n2 n3, psi
// by its per-lane extent, a coefficient grid by its own stride (0 for a
// grid shared by all lanes, n1 n2 n3 for a per-lane grid). Scalar
// coefficients are one value for every lane. A solo run is one lane.
// Offsets are 64-bit: at 1024^3 the stacked array holds more than 2^31
// elements.
//
// Shards (the sharded variant; the reference's ppermuted ghost operands,
// pallas_packed.py:1304-1320): a shard of a decomposed run (one lane)
// gets, per axis where a neighbour shard lies beyond the edge its
// differences reach, that neighbour's boundary plane (Params.ghost, a
// (3, plane) copy made between the launches by ops/stencil.py): E reads
// the lower neighbour's last plane of H, H the upper neighbour's first
// plane of new E. The x ghost is the march's first x neighbour, the y
// ghost the halo row of the tiles at the shard's edge (E: below row 0,
// H: above row n2 - 1), the z ghost the cell beside column 0 (E) or
// n3 - 1 (H), loaded like the halo, plane by plane. The PEC walls stand
// on the global edges only (open_lo/open_hi). That code is compiled into
// the sharded builds only (template SHARD, taken when a launch has a
// ghost or an open side): in the one build it cost the unsharded
// launches up to 23% (bf16 h_update, PERF.md section 6). A sharded
// launch computes each cell as the unsharded one does. The reference
// fixes the hi-edge H planes after its one-pass kernel (hi_edge_h_fix);
// here H runs after E and its patches, and reads the true plane.
//
// What bounds it on the card: memory bytes and requests. A launch must
// read the other family and its own family once and write its own once
// (9 field volumes), plus J or K (read and written), psi, the residuals
// and the grids inside their box; ~20 flops a cell.
//
// The design for the H100: each choice against its alternative in one
// call of scripts/packed_variants.py (ms of e_update + h_update on
// vacuum3D_tfsf's state at 256^3 in f32 / bf16 / compensated mode, and
// on the double-negative sphere at 256^3 (J, K, grids); NVIDIA H100
// 80GB HBM3, 700 W; PERF.md section 6). As built: 0.609 / 0.549 /
// 0.884 / 0.938 (one thread a cell before: 0.72 / 0.86 / 1.17 at 256^3,
// scripts/solo_kernel_times.py --packed in the same kind of call).
// 1. The old family, J or K and the residuals through the rings too
//    (one plane ahead in registers instead: 0.697 / 0.579 / 0.919 /
//    1.119 in an earlier call, where the rings-only timing-only build
//    showed the loads waiting on that prefetch), PIPE = 2 planes ahead
//    (1: 0.625 / 0.563 / 0.924 / 0.941; 3: 0.610 / 0.550 / 0.939 /
//    0.937).
// 2. Registers for four blocks an SM in float32 (three: 0.654 in f32,
//    1.032 on the sphere), three in bf16 and compensated mode (two:
//    0.663 / 0.930; four, with spills: 0.603 / 1.059).
// 3. Tiles of 8 rows, one warp a row (4 rows: 0.599 / 0.529 / 0.863 /
//    0.924 here, but 0.604 / 0.543 / 0.943 / 0.951 in the call before:
//    within the calls' spread; 16 rows: 0.633 / 0.629 / 1.099 / 0.967;
//    rows of two or four warps, 64 or 128 cells of f32, with a knob
//    since removed: 0.698 / 0.696 / 0.975 / 1.005 and 0.831 / 0.686 /
//    0.959 / 1.107). Two cells a
//    thread in bf16 and compensated mode (4-byte words and residual
//    words); in f32 two cells cost registers (0.797, 1.157 on the
//    sphere; with three blocks an SM 0.689 / 0.983).
// 4. x segments of 16 planes (8: 0.617 / 0.550 / 0.878 / 0.931; 32:
//    0.617 / 0.581 / 0.919 / 0.978; 64: 0.640 / 0.647 / 0.990 / 1.076).
// 5. Sections (every item in the slab kernel: 0.638 / 0.606 / 0.929 /
//    0.964); grids read inside their box only (every item reading them:
//    1.353 on the sphere).
// 6. 16-byte chunk copies into the rings, the block's threads taking the
//    tile's chunks in order, bought nothing (0.601 / 0.555 / 0.936 /
//    0.936 against 0.609 / 0.549 / 0.885 / 0.937 for these words in one
//    call): the loads do not wait on their number of requests.
// Timing-only builds split the time: the loads, barriers and rings
// alone 0.317 / 0.183 / 0.444 / 0.453, with the stores 0.461 / 0.241 /
// 0.598 / 0.616; the arithmetic the rest.
//
// Build knobs (-D): TY (tile rows), PIPE (planes in flight ahead of the
// march), F32_PAIRS (two cells a thread in the float32 build),
// SECTIONS, MIN_BLOCKS and F32_BLOCKS (resident blocks an SM the
// register budget is set for: the bf16 and compensated builds, the
// float32 build). The timing-only builds are source patches of
// scripts/packed_variants.py, not knobs of this file.
//
// Every entry returns cudaGetLastError() (or the first error) so the
// caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "march.cuh"

#ifndef TY
#define TY 8  // rows of a tile, one warp each
#endif
#ifndef PIPE
#define PIPE 2  // planes in flight ahead of the march
#endif
#ifndef F32_PAIRS
#define F32_PAIRS 0  // two z cells a thread in the float32 build
#endif
#ifndef SECTIONS
#define SECTIONS 1  // slab items and plain items by their own kernels
#endif
#ifndef MIN_BLOCKS
#define MIN_BLOCKS 3  // resident blocks an SM the registers are set for:
#endif                // bf16 and compensated builds
#ifndef F32_BLOCKS
#define F32_BLOCKS 4  // the float32 build's
#endif
#define NT (TY * 32)          // threads a block
#define SLOTS (PIPE + 1)      // ring planes
#define PLAN_COLS 8           // j0, k0, ny, nz, x0, x1, lane, flags
#define FLAG_GRID 1           // the item's cells reach the grids' box
#define FLAG_SLAB 2           // the item has a cell in a CPML slab
#if PIPE < 1 || PIPE > 3
#error "PIPE must lie in [1, 3]"
#endif

struct Coef {
  const float* grid;  // (n1, n2, n3), (lanes, n1, n2, n3) or nullptr
  long long lane;     // lane stride of grid: 0 (shared) or n1 n2 n3
  float val;          // used when grid is nullptr, and by the items
                      // outside the grids' box: the grid's background
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
  long long field_lane;  // lane stride of F, S, J and R: 3 n1 n2 n3
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
  int pairs;             // the plan's tiles take two z cells a thread
  const int* plan;       // (items, PLAN_COLS) work items, slab ones first
  int n_item[2];         // items of the slab and of the plain section
  // A shard of a decomposed run (one lane): per axis a, the neighbour's
  // plane beyond the edge the launch's differences reach, (3, the grid
  // without a) of the field type (E: the lower neighbour's last plane of
  // H, H: the upper neighbour's first plane of E), or nullptr: the PEC
  // zero. open_lo/open_hi: a shard lies beyond that side of axis a, so
  // the edge there is no PEC wall.
  const void* ghost[3];
  int open_lo[3];
  int open_hi[3];
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

// The slab plane of index ia on an axis of n cells with m-plane slabs,
// or -1 outside them.
__device__ __forceinline__ int slab_plane(int ia, int n, int m) {
  return ia < m ? ia : (ia >= n - m ? ia - (n - 2 * m) : -1);
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

// A coefficient's V cells: its grid where the item reads grids, else its
// scalar (for an item outside the grids' box, the grid's background).
template <int V>
__device__ __forceinline__ void coef_v(const Coef& c, bool grid, int lane,
                                       int64_t cell, float (&out)[V]) {
  if (grid && c.grid) {
    ldv<V>(c.grid + lane * c.lane + cell, out);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) out[v] = c.val;
  }
}

// Shared memory of a block, for fields of T and V cells a thread: the
// source ring (SLOTS planes of the tile, its halo row and halo column
// word, three components), then the own rings of the same depth (the
// old family, J or K when the launch has it, the residuals in
// compensated mode: the owned cells only, each thread's own words).
template <typename T, int V>
struct Ring {
  static constexpr int TZ = 32 * V;       // owned columns of a tile
  static constexpr int RW = TZ + V;       // a source ring row: the owned
                                          // cells and the halo word
  static constexpr int RP = (TY + 1) * RW;  // a source plane, a component
  static constexpr int OP = TY * TZ;        // an own plane, a component
  static constexpr int S_BYTES =
      round16(SLOTS * 3 * RP * static_cast<int>(sizeof(T)));
  static constexpr int F_BYTES =
      round16(SLOTS * 3 * OP * static_cast<int>(sizeof(T)));
  static constexpr int J_BYTES = round16(SLOTS * 3 * OP * 4);
  static constexpr int R_BYTES = round16(SLOTS * 3 * OP * 2);
  static int bytes(bool j, bool comp) {
    return S_BYTES + F_BYTES + (j ? J_BYTES : 0) + (comp ? R_BYTES : 0);
  }
};

// One work item: the march of one family's update over its x segment.
// BACKWARD = true: E from backward differences of H (with Drude J and
// PEC walls), marching x upwards; false: H from forward differences of E
// (with magnetic Drude K), marching downwards. COMP: compensated mode
// (float fields only). SLAB: the CPML psi path compiled in. T: the
// fields' storage type; V: z cells a thread. SHARD: a shard's ghost
// planes and open sides compiled in (the unsharded build has none of
// their code or registers).
template <bool BACKWARD, bool COMP, bool SLAB, typename T, int V, bool SHARD>
__global__ void __launch_bounds__(NT, sizeof(T) == 4 && !COMP ? F32_BLOCKS
                                                               : MIN_BLOCKS)
    family_march(const Params p, int first) {
  typedef Ring<T, V> Rg;
  constexpr int TZ = Rg::TZ, RW = Rg::RW, RP = Rg::RP, OP = Rg::OP;
  constexpr int COL0 = BACKWARD ? V : 0;  // the owned cells' first column
  constexpr int HCOL = BACKWARD ? 0 : TZ;  // the halo word's
  extern __shared__ __align__(16) unsigned char smem[];
  T* const ring = reinterpret_cast<T*>(smem);
  T* const fr = reinterpret_cast<T*>(smem + Rg::S_BYTES);
  float* const jr = reinterpret_cast<float*>(smem + Rg::S_BYTES +
                                             Rg::F_BYTES);
  bf16_t* const rr = reinterpret_cast<bf16_t*>(
      smem + Rg::S_BYTES + Rg::F_BYTES + (p.J ? Rg::J_BYTES : 0));

#if SECTIONS
  // the plain section's kernel reads no output of this one: it may start
  // on the SMs this kernel's last blocks leave free
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
#endif
  const int* it = p.plan + PLAN_COLS * (first + static_cast<int>(blockIdx.x));
  const int j0 = it[0], k0 = it[1], ny = it[2], nz = it[3];
  const int x0 = it[4], x1 = it[5], lane = it[6];
  const bool grid = (it[7] & FLAG_GRID) != 0;
  // warp w takes tile row w, its lane l the V cells from column l V on
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int n1 = p.n1, n2 = p.n2, n3 = p.n3;
  const int64_t vol = static_cast<int64_t>(n1) * n2 * n3;
  const int64_t pstride = static_cast<int64_t>(n2) * n3;
  const int64_t lane_off = lane * p.field_lane;
  T* const F = static_cast<T*>(p.F) + lane_off;
  const T* const S = static_cast<const T*>(p.S) + lane_off;
  float* const J = p.J ? p.J + lane_off : nullptr;
  bf16_t* const R = COMP ? p.R + lane_off : nullptr;
  // a shard's ghost planes (SHARD builds only; the unsharded build
  // keeps the expressions it had before them, so its registers and
  // spills are its own)
  const T* const G0 = static_cast<const T*>(p.ghost[0]);  // (3, n2, n3)
  const T* const G1 = static_cast<const T*>(p.ghost[1]);  // (3, n1, n3)
  const T* const G2 = static_cast<const T*>(p.ghost[2]);  // (3, n1, n2)

  // this thread's cells: row j, columns kk .. kk + V - 1
  const int j = j0 + w;
  const int kk = k0 + l * V;
  const bool own = w < ny && l * V < nz;
  const int at = (BACKWARD ? w + 1 : w) * RW + COL0 + l * V;  // in a slot
  const int oat = w * TZ + l * V;  // in an own ring plane
  // the halo row (E: below the tile, H: above it) and column word; a
  // halo row outside the shard comes from the y ghost plane
  const int hj = BACKWARD ? j0 - 1 : j0 + ny;
  const bool hin = hj >= 0 && hj < n2;
  const bool hrow = SHARD ? w == 0 && (hin || G1) && l * V < nz
                          : w == 0 && hj >= 0 && hj < n2 && l * V < nz;
  const int hat = (BACKWARD ? 0 : ny) * RW + COL0 + l * V;
  const int hk = BACKWARD ? k0 - V : k0 + TZ;
  const bool hcol = w == TY - 1 && l < ny &&
                    (BACKWARD ? k0 > 0 : nz == TZ && k0 + TZ < n3);
  const int hcat = (BACKWARD ? l + 1 : l) * RW + HCOL;
  const int64_t own_off = static_cast<int64_t>(j) * n3 + kk;
  const int64_t hrow_off = static_cast<int64_t>(hj) * n3 + kk;
  const int64_t hcol_off = static_cast<int64_t>(j0 + l) * n3 + hk;
  // the z neighbour beyond the shard's edge (E: left of column 0, H:
  // right of column n3 - 1), one cell a row from the z ghost plane, at
  // the ring cell the march reads it from
  const bool zg = SHARD && G2 && w == TY - 1 && l < ny &&
                  (BACKWARD ? k0 == 0 : k0 + nz == n3);
  const int zgat = BACKWARD ? (l + 1) * RW + V - 1 : l * RW + nz;
  const int64_t n12 = static_cast<int64_t>(n1) * n2;

  // facts of the thread's columns, fixed over the march
  const int qy = SLAB ? slab_plane(j, n2, p.m[1]) : -1;
  // a PEC wall is a global edge: a shard's edge toward a neighbour is none
  const bool y_wall = SHARD ? (j == 0 && !p.open_lo[1]) ||
                                  (j == n2 - 1 && !p.open_hi[1])
                            : j == 0 || j == n2 - 1;
  int qz[V];
  bool z_wall[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    qz[v] = SLAB ? slab_plane(kk + v, n3, p.m[2]) : -1;
    z_wall[v] = SHARD ? (kk + v == 0 && !p.open_lo[2]) ||
                            (kk + v == n3 - 1 && !p.open_hi[2])
                      : kk + v == 0 || kk + v == n3 - 1;
  }

  // the source family's plane i into ring slot `slot`, and the thread's
  // own old family, J or K and residuals of plane i into its own slots
  auto load_plane = [&](int i, int slot) {
    T* rs = ring + slot * 3 * RP;
    const int64_t base = static_cast<int64_t>(i) * pstride;
    if (own) {
      const int64_t cell = base + own_off;
      const int os = slot * 3 * OP + oat;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        copy_word<V>(rs + c * RP + at, S + c * vol + cell);
        copy_word<V>(fr + os + c * OP, F + c * vol + cell);
        if (J) copy_word<V>(jr + os + c * OP, J + c * vol + cell);
        if (COMP) copy_word<V>(rr + os + c * OP, R + c * vol + cell);
      }
    }
    if (hrow && (!SHARD || hin)) {  // components 0 and 2: the y terms
      copy_word<V>(rs + hat, S + base + hrow_off);
      copy_word<V>(rs + 2 * RP + hat, S + 2 * vol + base + hrow_off);
    }
    if (hcol) {  // components 0 and 1 have the z terms
      copy_word<V>(rs + hcat, S + base + hcol_off);
      copy_word<V>(rs + RP + hcat, S + vol + base + hcol_off);
    }
    if constexpr (SHARD) {
      if (hrow && !hin) {  // the y ghost plane's row of plane i
        const T* g = G1 + static_cast<int64_t>(i) * n3 + kk;
        copy_word<V>(rs + hat, g);
        copy_word<V>(rs + 2 * RP + hat,
                     g + 2 * static_cast<int64_t>(n1) * n3);
      }
      if (zg) {  // the z ghost plane's cell of row j0 + l, plane i
        const T* g = G2 + static_cast<int64_t>(i) * n2 + j0 + l;
        rs[zgat] = g[0];
        rs[RP + zgat] = g[n12];
      }
    }
  };

  const int dir = BACKWARD ? 1 : -1;
  const int start = BACKWARD ? x0 : x1 - 1;
  const int count = x1 - x0;
  // the x neighbours of the first plane (E: H(x0 - 1), H: E(x1)) of
  // components 1 and 2, the two with an x term; outside the shard the
  // x ghost plane, or the PEC zero
  float xn[2][V];
  {
    const int xi = start - dir;
    const bool in = own && xi >= 0 && xi < n1;
    const bool ghost = SHARD && own && !in && G0;  // the x ghost plane
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      if (in) {
        ldv<V>(S + (d + 1) * vol + static_cast<int64_t>(xi) * pstride +
                   own_off,
               xn[d]);
      } else if (ghost) {
        ldv<V>(G0 + (d + 1) * pstride + own_off, xn[d]);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) xn[d][v] = 0.f;
      }
    }
  }
  // every source ring cell a load does not fill stays 0: the PEC ghosts
  // (a shard's ghost planes are loaded like the halo, plane by plane)
  for (int t = threadIdx.x; t < Rg::S_BYTES / 4; t += NT) {
    reinterpret_cast<unsigned*>(smem)[t] = 0u;
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < PIPE; ++q) {
    if (q < count) load_plane(start + q * dir, q % SLOTS);
    cp_commit();
  }

  for (int s = 0; s < count; ++s) {
    const int i = start + s * dir;
    cp_wait<PIPE - 1>();  // this thread's copies of plane i have landed
    __syncthreads();      // everyone's have; plane i - dir is retired
    if (s + PIPE < count) load_plane(i + PIPE * dir, (s + PIPE) % SLOTS);
    cp_commit();
    if (!own) continue;
    const T* rs = ring + (s % SLOTS) * 3 * RP + at;
    const int os = (s % SLOTS) * 3 * OP + oat;
    float here[3][V];
#pragma unroll
    for (int d = 0; d < 3; ++d) ldv<V>(rs + d * RP, here[d]);
    const int64_t cell0 = static_cast<int64_t>(i) * pstride + own_off;
    const int qx = SLAB ? slab_plane(i, n1, p.m[0]) : -1;
    const bool x_wall = SHARD ? (i == 0 && !p.open_lo[0]) ||
                                    (i == n1 - 1 && !p.open_hi[0])
                              : i == 0 || i == n1 - 1;

#pragma unroll
    for (int c = 0; c < 3; ++c) {
      // the differences of the two curl terms, each cell
      float d0[2][V];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int a = term_axis(c, t);
        const int d = term_comp(c, t);
        float nb[V];
        if (a == 0) {
#pragma unroll
          for (int v = 0; v < V; ++v) nb[v] = xn[d - 1][v];
        } else if (a == 1) {
          ldv<V>(rs + d * RP + (BACKWARD ? -RW : RW), nb);
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) {
            // the cell beside it: in the thread's own word, else the
            // neighbouring word's (or the halo word's) nearest cell
            if (BACKWARD) {
              nb[v] = v == 0 ? ld(rs + d * RP - 1)
                             : here[d][v > 0 ? v - 1 : 0];
            } else {
              nb[v] = v == V - 1 ? ld(rs + d * RP + V)
                                 : here[d][v < V - 1 ? v + 1 : v];
            }
          }
        }
#pragma unroll
        for (int v = 0; v < V; ++v) {
          d0[t][v] = BACKWARD ? here[d][v] - nb[v] : nb[v] - here[d][v];
        }
      }
      float ca[V], cb[V], ka[V], kb[V], rv[V], jn[V], out[V], ro[V];
      coef_v<V>(p.a[c], grid, lane, cell0, ca);
      coef_v<V>(p.b[c], grid, lane, cell0, cb);
      if (J) {
        coef_v<V>(p.kj[c], grid, lane, cell0, ka);
        coef_v<V>(p.bj[c], grid, lane, cell0, kb);
      }
      float old[V], jo[V];
      ldv<V>(fr + os + c * OP, old);
      if (J) ldv<V>(jr + os + c * OP, jo);
      if (COMP) ldv<V>(rr + os + c * OP, rv);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int k = kk + v;
        float acc = 0.f;
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int a = term_axis(c, t);
          const float sg = t == 0 ? 1.f : -1.f;
          const float dv = d0[t][v];
          // the scaled difference rounded on its own (never contracted
          // into the accumulator's add): a cell sums the same values
          // in the slab kernel, which keeps dfa for psi, as in the plain
          // one, so a shard's identity slab cells match the unsharded
          // run bit for bit
          const float dfa = COMP ? add_rn(mul_rn(dv, p.inv_dx),
                                          mul_rn(dv, p.inv_dx_lo))
                                 : mul_rn(dv, p.inv_dx);
          if (SLAB) {
            const int q = a == 0 ? qx : (a == 1 ? qy : qz[v]);
            if (q >= 0) {
              const int m = p.m[a];
              const int row = c < a ? c : c - 1;
              const int64_t off = psi_offset(a, row, q, i, j, k, n1, n2, n3,
                                             2 * m);
              const float* pr = p.prof[a];
              float* ps = p.psi[a] + lane * p.psi_lane[a] + off;
              if (COMP) {
                const float psi = add_rn(mul_rn(pr[q], *ps),
                                         mul_rn(pr[2 * m + q], dfa));
                *ps = psi;
                acc = add_rn(acc, mul_rn(sg, add_rn(mul_rn(sub_rn(
                                                        pr[4 * m + q], 1.f),
                                                    dfa),
                                             psi)));
              } else {
                const float psi = pr[q] * *ps + pr[2 * m + q] * dfa;
                *ps = psi;
                acc += sg * ((pr[4 * m + q] - 1.f) * dfa + psi);
              }
            }
          }
          acc = COMP ? add_rn(acc, mul_rn(sg, dfa)) : acc + sg * dfa;
        }
        const float o = old[v];
        if (J) {  // the ADE current: J' taken off E's acc, K' added to H's
          jn[v] = COMP ? add_rn(mul_rn(ka[v], jo[v]), mul_rn(kb[v], o))
                       : ka[v] * jo[v] + kb[v] * o;
          if (COMP) {
            acc = BACKWARD ? sub_rn(acc, jn[v]) : add_rn(acc, jn[v]);
          } else {
            acc = BACKWARD ? acc - jn[v] : acc + jn[v];
          }
        }
        // PEC walls: tangential E vanishes on the walls of the two axes
        // other than its own
        const bool wall = BACKWARD && ((c != 0 && x_wall) ||
                                       (c != 1 && y_wall) ||
                                       (c != 2 && z_wall[v]));
        float val;
        if (COMP) {
          // Kahan: new = old + y, y = u - r, with the stored residual r
          const float am1 = mul_rn(sub_rn(ca[v], 1.f), o);
          const float lo_a = mul_rn(p.a_lo[c], o);
          const float u =
              BACKWARD ? add_rn(add_rn(am1, mul_rn(cb[v], acc)),
                                add_rn(lo_a, mul_rn(p.b_lo[c], acc)))
                       : add_rn(sub_rn(am1, mul_rn(cb[v], acc)),
                                sub_rn(lo_a, mul_rn(p.b_lo[c], acc)));
          const float y = sub_rn(u, rv[v]);
          val = add_rn(o, y);
          ro[v] = wall ? 0.f : sub_rn(sub_rn(val, o), y);
        } else if (BACKWARD) {
          val = ca[v] * o + cb[v] * acc;
        } else {
          val = ca[v] * o - cb[v] * acc;
        }
        out[v] = wall ? 0.f : val;
      }
      stv<V>(F + c * vol + cell0, out);
      if (J) stv<V>(J + c * vol + cell0, jn);
      if (COMP) stv<V>(R + c * vol + cell0, ro);
    }
    // this plane is the next one's x neighbour
#pragma unroll
    for (int v = 0; v < V; ++v) {
      xn[0][v] = here[1][v];
      xn[1][v] = here[2][v];
    }
  }
  cp_wait<0>();  // the last groups are empty; none stays in flight
}

typedef void (*Kernel)(const Params, int);

// The builds: [sharded][family][storage][cells a thread][section].
// Sharded 0: the unsharded kernels, 1: with ghost planes and open sides;
// storage 0 float32, 1 bf16, 2 compensated float32; cells a thread 0:
// one, 1: two (the float32 build's two-cell entry is its one-cell kernel
// unless F32_PAIRS); section 0 the slab kernel, 1 the plain one (the
// slab kernel too when SECTIONS is 0).
#if SECTIONS
#define SECTION_PAIR(B, C, T, V, S) \
  { family_march<B, C, true, T, V, S>, family_march<B, C, false, T, V, S> }
#else
#define SECTION_PAIR(B, C, T, V, S) \
  { family_march<B, C, true, T, V, S>, family_march<B, C, true, T, V, S> }
#endif
#define F32_EVEN_V (F32_PAIRS ? 2 : 1)
#define FAMILY_KERNELS(B, S)                                               \
  {                                                                        \
    {SECTION_PAIR(B, false, float, 1, S),                                  \
     SECTION_PAIR(B, false, float, F32_EVEN_V, S)},                        \
        {SECTION_PAIR(B, false, bf16_t, 1, S),                             \
         SECTION_PAIR(B, false, bf16_t, 2, S)},                            \
        {SECTION_PAIR(B, true, float, 1, S),                               \
         SECTION_PAIR(B, true, float, 2, S)}                               \
  }
static const Kernel kKernels[2][2][3][2][2] = {
    {FAMILY_KERNELS(true, false), FAMILY_KERNELS(false, false)},
    {FAMILY_KERNELS(true, true), FAMILY_KERNELS(false, true)}};
#define N_KERNELS 48  // every entry of kKernels

// Entry q of kKernels in its order.
static Kernel kernel_at(int q) {
  return kKernels[q / 24][(q / 12) % 2][(q / 4) % 3][(q / 2) % 2][q % 2];
}

// Whether a launch takes two z cells a thread: rows of an even n3 are
// aligned to words of two cells; bf16 and compensated always pair them,
// float32 where F32_PAIRS says.
static bool pairs_for(int bf16, int comp, int n3) {
  return n3 % 2 == 0 && (bf16 || comp || F32_PAIRS);
}

// Dynamic shared memory of a launch (Ring<T, V>::bytes) by storage (0
// float32, 1 bf16, 2 compensated float32) and cells a thread.
static int launch_smem(int storage, bool pairs, bool j) {
  switch (storage * 2 + (pairs ? 1 : 0)) {
    case 0:
      return Ring<float, 1>::bytes(j, false);
    case 1:
      return Ring<float, F32_EVEN_V>::bytes(j, false);
    case 2:
      return Ring<bf16_t, 1>::bytes(j, false);
    case 3:
      return Ring<bf16_t, 2>::bytes(j, false);
    case 4:
      return Ring<float, 1>::bytes(j, true);
    default:
      return Ring<float, 2>::bytes(j, true);
  }
}

// Lets every kernel take as much dynamic shared memory as the card
// offers a block and prefer shared memory over L1, once.
static cudaError_t set_attributes() {
  static bool done = false;
  if (done) return cudaSuccess;
  int dev = 0, most = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  for (int q = 0; q < N_KERNELS && err == cudaSuccess; ++q) {
    const Kernel k = kernel_at(q);
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               most);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(k,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    }
  }
  if (err == cudaSuccess) done = true;
  return err;
}

static int launch(const Params* p, void* stream, bool backward) {
  cudaError_t err0 = set_attributes();
  if (err0 != cudaSuccess) return static_cast<int>(err0);
  if (p->lanes < 1 || p->n_item[0] < 0 || p->n_item[1] < 0) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  if (p->R && p->bf16) {  // compensated mode is float32 only
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (p->lanes != 1 && (p->ghost[0] || p->ghost[1] || p->ghost[2])) {
    return static_cast<int>(cudaErrorInvalidValue);  // ghosts: one lane
  }
  const bool pairs = pairs_for(p->bf16, p->R != nullptr, p->n3);
  if (pairs != (p->pairs != 0)) {  // a plan made for another tile width
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int storage = p->R ? 2 : (p->bf16 ? 1 : 0);
  bool shard = false;  // the sharded build, where a shard has a neighbour
  for (int a = 0; a < 3; ++a) {
    shard = shard || p->ghost[a] || p->open_lo[a] || p->open_hi[a];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int first = 0;
  bool launched = false;
  for (int q = 0; q < 2; ++q) {
    const int n = p->n_item[q];
    if (n > 0) {
      int at = first;
      void* args[] = {const_cast<Params*>(p), &at};
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(n);
      cfg.blockDim = dim3(NT);
      cfg.dynamicSmemBytes = launch_smem(storage, pairs, p->J != nullptr);
      cfg.stream = s;
      // the plain section may overlap the slab one (programmatic
      // dependent launch): they write disjoint cells and read only the
      // other family and what the work before the launch wrote
      cudaLaunchAttribute attr;
      attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
      attr.val.programmaticStreamSerializationAllowed = 1;
      cfg.attrs = &attr;
      cfg.numAttrs = SECTIONS && launched ? 1 : 0;
      const Kernel k = kKernels[shard ? 1 : 0][backward ? 0 : 1][storage]
                               [pairs ? 1 : 0][q];
      cudaError_t err =
          cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(k), args);
      if (err == cudaSuccess) err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      launched = true;
    }
    first += n;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" {

int fdtd_params_size() { return static_cast<int>(sizeof(Params)); }

// The geometry a plan must follow for a launch of this build: out = {tile
// rows, tile columns (also the alignment of the z cuts), sections (1:
// the plan splits slab and plain items), two cells a thread (1) or
// one}.
int fdtd_packed_tile(int bf16, int comp, int n3, int* out) {
  const bool pairs = pairs_for(bf16, comp, n3);
  out[0] = TY;
  out[1] = 32 * (pairs ? 2 : 1);
  out[2] = SECTIONS;
  out[3] = pairs ? 1 : 0;
  return 0;
}

// Per kernel of kKernels in its order (sharded, family, storage, cells a
// thread, section), four ints: registers a thread, local (spill) bytes a
// thread, resident blocks an SM (without J or K), static shared bytes.
int fdtd_packed_occupancy(int* out) {
  cudaError_t err = set_attributes();
  for (int q = 0; q < N_KERNELS && err == cudaSuccess; ++q) {
    const Kernel k = kernel_at(q);
    cudaFuncAttributes a;
    err = cudaFuncGetAttributes(&a, k);
    int blocks = 0;
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, k, NT, launch_smem((q / 4) % 3, (q / 2) % 2, false));
    }
    out[4 * q] = a.numRegs;
    out[4 * q + 1] = static_cast<int>(a.localSizeBytes);
    out[4 * q + 2] = blocks;
    out[4 * q + 3] = static_cast<int>(a.sharedSizeBytes);
  }
  return static_cast<int>(err);
}

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
