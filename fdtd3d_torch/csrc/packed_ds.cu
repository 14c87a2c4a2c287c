// Packed double-single (float32x2) leapfrog step of the 3D Yee scheme,
// for Hopper (sm_90a): the incident line in one launch, then E and H in
// one x-marching pass.
//
// Replaces the Pallas TPU kernel
// fdtd3d_tpu/ops/pallas_packed_ds.py::make_packed_ds_step (factory :193,
// kernel :364 with body :429, pallas_call :936) for unsharded 3D
// float32x2 runs, and the reference step's host part around it (the ds
// incident line, tfsf.py, and the record terms).
//
// What one step computes, on the reference's stacked layout
// E, H = (6, n1, n2, n3) float32, rows [0,3) hi words and [3,6) lo
// words, C order, z innermost, every value the pair hi + lo:
//   Einc' = ae Einc - be dHinc (hard source pair at cell 0),
//   Hinc' = ah Hinc - bh dEinc'                   (the ds line, ds_line)
//   E' = ca E + cb (curl_b H + CPML terms + source records - J'),
//   J' = kj J + bj E_hi                           (plain f32, as the
//                                                  reference keeps it)
//   H' = da H - db (curl_f E' + CPML terms + source records + K'),
//   K' = km K + bm H_hi                           (magnetic Drude, plain
//                                                  f32 likewise)
// with each difference, product and sum an error-free-transform (EFT)
// sequence: the differences are exact (two_diff) and scaled by 1/dx as
// a pair, the slab CPML runs as pair recursions on compact slab stacks
// (psi' = b psi + c d, term = ik d + psi'), each source record's plane
// term is added into the accumulator pair at its plane before the
// coefficient multiply, in table order, and ca/cb/da/db are pairs
// (scalars or grids); J' and K' enter the accumulator pair after the
// records, by add_f (the reference's jnp-ds order; its kernel adds K in
// the lagged H phase, pallas_packed_ds.py:746-756, as this pass does:
// K of a cell is read and written where its H is). km/bm are grids
// read only inside their box (where they differ from the background)
// or scalars. A record's term is computed in the kernel from
// the line: v = Einc or Hinc interpolated as v0 (1 - w) + v1 w with the
// pairs of the record's fixed geometry (ops/packed_ds.py::
// build_term_plan), times its sign*pol/dx pair, times its 0/1 gate. E
// records sample the line's Hinc before this step's advance, H records
// its advanced Einc: the line is double-buffered (ds_line reads one
// buffer and writes the other), and the pass reads Hinc from the first
// and Einc from the second. Every operation is the plain PyTorch
// version's, in its order (ops/tfsf.py::_advance_einc_ds and
// _advance_hinc_ds, ops/packed_ds.py::record_terms, e_update_plain and
// h_update_plain).
//
// The EFT hazard. A compiler that contracts a*b + c into one FMA, or
// reassociates, breaks two_sum, two_prod and everything built on them.
// Every EFT operation below is therefore written with the explicitly
// rounded intrinsics __fadd_rn/__fsub_rn/__fmul_rn, which nvcc never
// contracts, and the library is also built with --fmad=false. No fast
// math: the lo words may be subnormal and must not be flushed.
// two_prod is Dekker's split product (no fmaf), so the kernel computes
// the same bits as the reference and the plain PyTorch version in every
// case, underflow included. FMA_PROD=1 builds the two-op product
// (p = a b, e = fma(a, b, -p)) as a measured variant only
// (scripts/ds_variants.py), since it differs from Dekker's where the
// split's partial products underflow or overflow.
//
// The march (ds_pass). A thread block owns a work item of the host's
// plan (ops/packed_ds.py::plan_items): a (y, z) tile of at most
// (BY - 2) x (BZ - 2) owned cells over an x segment [x0, x1). One thread
// per (y, z) column of the tile plus a 1-cell halo on each side marches x
// from x0 to x1 and at plane i computes E(i) (the new E) and then H(i-1)
// (the new H, from E(i-1) and E(i)), with one barrier a plane: H(i-1)
// reads E(i) only at its own column, which the same thread has just
// written, and E(i-1) at its neighbours', which the plane's barrier
// published.
// E reads H at y-1, z-1 and x-1 (backward differences) and H reads the
// new E at y+1, z+1 and x+1 (forward), so E is computed on the owned
// cells and the +y/+z halo row and column and on plane x1 (redundantly,
// with their own psi, J, records and walls), and H on the owned cells
// only: one launch moves E and H once each, 96 B/cell a step, against
// the two in-place launches' 144. The old H of planes i and i-1 and the
// old E of plane i stream into shared-memory plane rings PIPE planes
// ahead of the march by cp.async (4 bytes a thread and word: each thread
// copies its own column; the barrier that opens a plane, which the march
// needs anyway, publishes it); the new E of planes i and i-1 sits in a
// two-plane ring. Neighbours are read from the rings, never from device
// memory.
//
// Out of place. A block reads halo cells of E, H, psi and J that a
// neighbouring block owns, so the pass reads only the source buffers
// (*0) and writes only the destination ones (*2); a halo cell computes
// its new psi and J for its own E but never stores them, only the owner
// stores a cell's E, H, psi and J, and every cell has exactly one owner
// (the plan tiles the grid). The caller swaps the two buffer sets.
//
// The design for the H100. Each choice against its alternative in one
// call of scripts/ds_variants.py (ms of the pass at 256^3 / 128^3 on the
// precision example's state; NVIDIA H100 80GB HBM3, 700 W; PERF.md):
// as built 1.81 / 0.35; the first design (16 x 32-thread blocks, two an
// SM, tiles cut band by band, 8-plane segments) 2.10 / 0.43.
// 1. One pass: E and H in one march beat two launches a section (E, then
//    H reading the new E back: 2.38 / 0.47 against the first design's
//    2.10 / 0.43; that variant's source is not kept).
// 2. Occupancy: 32 x 32-thread blocks (30 x 30 owned), one an SM at 64
//    registers without spills (16 x 32 two an SM 1.89 / 0.37, one an SM
//    at 83-96 registers 2.29 / 0.46; 8 x 32 four an SM 1.98 / 0.40; 8 x
//    64 two an SM 2.32 / 0.47; 16 x 64 one an SM 2.27 / 0.45). The old E
//    is a ring slot only its own thread reads, so it needs PIPE + 1
//    planes; old fields in flight two planes ahead do not fit a 32 x 32
//    block's shared memory (16 x 32, one an SM: 2.33 / 0.47).
// 3. One barrier a plane (see the march); the three components' chains
//    of a cell are computed stage by stage (curl sums, records, J,
//    coefficients) so the compiler can interleave them.
// 4. Sections: the items whose computed cells touch a CPML slab run the
//    edge kernel (the slab path compiled in), the others the inner
//    kernel (every item in the edge kernel: 1.89 / 0.35); the inner
//    kernel may start on the SMs the edge kernel leaves free
//    (programmatic dependent launch: the two write disjoint cells and
//    read only the source buffers and the line; without: 1.93 / 0.43).
//    Coefficient grids, Drude J and magnetic Drude K are compiled out of
//    the calls that have none. K is the simple first design: read and
//    written in device memory at the H phase's cell (no ring: only the
//    cell's own thread reads it), 24 B/cell more a step.
// 5. Each axis cut whole into near-equal tiles (cut band by band, the
//    band tiles 8-9 cells wide: 2.25 / 0.49), over x segments of 16
//    planes where that gives every SM four items, else 10 (10 at 256^3:
//    1.84; 16 at 128^3: 0.45; 6, 8, 12: 1.94 / 0.35, 1.89 / 0.37, 1.83
//    / 0.37); tiles up to 30 cells wide anywhere along z (24 wide at
//    multiples of 8, whole sectors: 2.09 / 0.40).
// 6. Records cost nothing where they are absent: each family's record
//    table lives in shared memory with per-component and x-normal bit
//    masks; a column holds the bits of the y- and z-normal records whose
//    plane holds it, a plane the bits of its x-normal records, and a
//    cell adds the records of those bits in table order.
// 7. Index math is 32-bit inside a plane and a psi stack, on 64-bit plane
//    and component bases.
//
// What bounds it on the card: a step must move E and H once each (96
// B/cell) plus the psi slabs, and do ~1,000 f32 operations a cell for
// both families, which --fmad=false and the explicitly rounded
// intrinsics issue at the card's non-FMA rate (~33.5 T op/s on an H100
// SXM): the bytes' time and the operations' time are about equal (0.56
// and 0.58 ms at 256^3). The pass reaches 32% of that. Timing-only
// builds (source patches of scripts/ds_variants.py, 10-plane segments)
// show where the rest goes: the march's loads and stores alone take
// 1.19 ms, of which the stores of the new E and H (rows of up to 30
// cells, 12 of them a cell column and plane) 0.85 and the loads 0.40;
// barriers and ring traffic alone 0.07; the arithmetic adds 0.65 on
// top. Stores marked evict-first changed nothing in the first design
// (2.10; not kept); the FMA product (FMA_PROD) takes 1.64 / 0.32 but
// differs from Dekker's product in the low word where the split's
// partial products underflow, so it stays a variant.
//
// Shards (the sharded variant; the reference's pair ghosts and hi-edge
// fix, pallas_packed_ds.py:1198-1280): a shard of a decomposed run gets,
// per axis with a lower neighbour, that neighbour's last plane of old H
// as a pair (Params.glo, a (6, plane) copy made before the pass by
// ops/stencil.py), and the PEC walls stand on the global edges only
// (open_lo/open_hi). The x ghost is the march's plane x0 - 1 at x0 = 0,
// the y and z ghosts the halo row and column below the tiles at the
// shard's lo edges, loaded into the old-H ring like the halo. That code
// is compiled into the sharded builds only (template SHARD, taken when a
// launch has a ghost or an open side), so the unsharded builds keep
// their code. The pass is out of place, so H on a shard's hi edge, whose
// forward differences reach into the upper neighbour's new E, is
// computed with the zero ghost and then computed again, whole, by
// ds_hi_edge: after the pass of every shard and the exchange of the
// upper neighbours' first planes of new E (Params.ghi), it runs the
// pass's own cell code (update<false, 7, GRID>) on the union of the
// shard's hi-edge planes, from the source buffers H0, psH0 and K0, and
// overwrites what the pass wrote there. Every cell of a sharded step
// thus runs the unsharded step's operations: a shard edge inside the
// grid lies in the shard's slab planes, whose profiles there are
// exactly identity, and a pair passes through the identity recursion
// unchanged. The reference adds the missing term to the zero-ghost H
// instead (pallas_packed_ds.py:1237-1280).
//
// Build knobs (-D): BY, BZ (threads of a block, halo included), PIPE,
// INNER_BLOCKS, EDGE_BLOCKS, OVERLAP, FMA_PROD. The timing-only builds
// are source patches of scripts/ds_variants.py, not knobs of this file.
//
// Every entry returns cudaGetLastError() (or the first error) so the
// caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_REC 16      // records per family; mirrors ops/packed_ds.py
#define PLAN_COLS 8     // ints a plan row: j0, k0, ny, nz, x0, x1, class, pad
#define SECTIONS 2      // the edge kernel, then the inner one
#define MAX_SLAB_SUM 256  // CPML planes a side summed over the axes
#define LINE_THREADS 1024
#ifndef BZ
#define BZ 32  // block extent along z (threadIdx.x), halo included
#endif
#ifndef BY
#define BY 32  // block extent along y (threadIdx.y), halo included
#endif
#ifndef PIPE
#define PIPE 1  // planes of old fields in flight ahead of the march
#endif
#ifndef INNER_BLOCKS
#define INNER_BLOCKS 1  // resident blocks an SM the inner kernel is built for
#endif
#ifndef EDGE_BLOCKS
#define EDGE_BLOCKS 1  // resident blocks an SM the edge kernel is built for
#endif
#ifndef OVERLAP
#define OVERLAP 1  // the inner kernel may start while the edge one ends
#endif
#ifndef FMA_PROD
#define FMA_PROD 0  // 1: two_prod by fma (a measured variant only)
#endif
#define NT (BZ * BY)
#define PL (6 * NT)  // floats of one ring plane: 3 hi words, 3 lo words
// an H ring slot is refilled PIPE planes ahead, while other threads of
// the iteration before may still read the planes i-1 and i-2; an old-E
// slot is read only by the thread that loads it, which has used its
// plane before it refills the slot
#define RING ((PIPE + 3) <= 4 ? 4 : 8)
#define ERING (PIPE + 1)
#if PIPE < 1 || PIPE > 5
#error "PIPE must lie in [1, 5]"
#endif

struct PairCoef {
  const float* hi;  // (n1, n2, n3) grids, or nullptr for the scalar pair
  const float* lo;
  float vh, vl;
};

struct Coef {
  const float* grid;  // (n1, n2, n3) or nullptr
  float val;
};

// A plain f32 coefficient read from its grid only inside the grid's box
// (where it differs from its background), else the scalar `val`.
struct BoxCoef {
  const float* grid;  // (n1, n2, n3) or nullptr (a scalar everywhere)
  float val;          // the scalar, or the grid's background value
  int lo[3], hi[3];   // the box, inclusive bounds per axis
};

struct Rec {
  int off;    // offset of the record's plane cells in the geometry
  int comp;   // component index within the family
  int axis;   // normal axis of the plane
  int plane;  // index of the plane along `axis`
  int point;  // 1: the point source at (plane, pj, pk), pair (pt_h, pt_l)
  int pad;
};

struct Family {
  PairCoef a[3];          // ca (E) / da (H)
  PairCoef b[3];          // cb (E) / db (H)
  const float* prof[3];   // per axis a: (6, 2 m[a]) b, c, ik hi then lo
  const float* line_h;    // the line half the records sample: Hinc before
  const float* line_l;    // the advance (E), Einc after it (H)
  Rec rec[MAX_REC];
  int n_rec;
};

struct Params {
  const float* E0;        // source stacks (6, n1, n2, n3), read only
  const float* H0;
  const float* J0;        // Drude J (3, n1, n2, n3) or nullptr
  float* E2;              // destination stacks, written only
  float* H2;
  float* J2;
  const float* K0;        // magnetic Drude K (3, n1, n2, n3) or nullptr
  float* K2;
  const float* psE0[3];   // per axis a: (4, n with dim a = 2 m[a]) or null
  const float* psH0[3];
  float* psE2[3];
  float* psH2[3];
  const float* geo;       // (7, total): w, ow, scale pairs, gate
  const int* geo_i0;      // (total,): interpolation index into the half
  long long total;
  const int* plan;        // (items, PLAN_COLS) work items, by section
  Family fe, fh;
  Coef kj[3];             // Drude, E only
  Coef bj[3];
  BoxCoef km[3];          // magnetic Drude, H only
  BoxCoef bm[3];
  int m[3];               // slab planes per side, 0 = no CPML on the axis
  int pj, pk;             // the point source's column
  int n1, n2, n3;
  int n_item[SECTIONS];   // items of each section, in launch order
  float iv_h, iv_l;       // 1/dx as a pair
  float pt_h, pt_l;       // the point source's pair this step
  // a shard of a decomposed run (the sharded builds): per axis a, the
  // lower neighbour's last plane of old H and the upper neighbour's
  // first plane of new E, (6, the grid without a) pairs or nullptr, and
  // whether a neighbour lies below / above (no PEC wall there)
  const float* glo[3];
  const float* ghi[3];
  int open_lo[3];
  int open_hi[3];
};

struct Line {
  const float* src[4];    // Einc, Einc_lo, Hinc, Hinc_lo at the step's start
  float* dst[4];          // the advanced line (another buffer)
  const float* co[8];     // ae, ae_lo, be, be_lo, ah, ah_lo, bh, bh_lo
  int n;
  float sh, sl;           // the hard source's pair at cell 0
};

// ---------------------------------------------------------------------
// error-free transforms (fdtd3d_torch/ops/ds.py, op for op)
// ---------------------------------------------------------------------

__device__ __forceinline__ void two_sum(float a, float b, float& s,
                                        float& e) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

__device__ __forceinline__ void two_diff(float a, float b, float& s,
                                         float& e) {
  s = __fsub_rn(a, b);
  const float bb = __fsub_rn(s, a);
  e = __fsub_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fadd_rn(b, bb));
}

__device__ __forceinline__ void split(float a, float& hi, float& lo) {
  const float t = __fmul_rn(4097.0f, a);
  hi = __fsub_rn(t, __fsub_rn(t, a));
  lo = __fsub_rn(a, hi);
}

__device__ __forceinline__ void two_prod(float a, float b, float& p,
                                         float& e) {
  p = __fmul_rn(a, b);
#if FMA_PROD
  e = __fmaf_rn(a, b, -p);
#else
  float ah, al, bh, bl;
  split(a, ah, al);
  split(b, bh, bl);
  e = __fadd_rn(__fadd_rn(__fadd_rn(__fsub_rn(__fmul_rn(ah, bh), p),
                                    __fmul_rn(ah, bl)),
                          __fmul_rn(al, bh)),
                __fmul_rn(al, bl));
#endif
}

// (ah, al) + (bh, bl), renormalised with the full two_sum
__device__ __forceinline__ void add_ff(float ah, float al, float bh,
                                       float bl, float& rh, float& rl) {
  float sh, se, te, tf;
  two_sum(ah, bh, sh, se);
  two_sum(al, bl, te, tf);
  se = __fadd_rn(se, te);
  two_sum(sh, se, sh, se);
  se = __fadd_rn(se, tf);
  two_sum(sh, se, rh, rl);
}

// (ah, al) + plain f32 b
__device__ __forceinline__ void add_f(float ah, float al, float b,
                                      float& rh, float& rl) {
  float sh, se;
  two_sum(ah, b, sh, se);
  se = __fadd_rn(se, al);
  two_sum(sh, se, rh, rl);
}

// (ah, al) * (bh, bl)
__device__ __forceinline__ void mul_ff(float ah, float al, float bh,
                                       float bl, float& rh, float& rl) {
  float p, e;
  two_prod(ah, bh, p, e);
  e = __fadd_rn(e, __fadd_rn(__fmul_rn(ah, bl), __fmul_rn(al, bh)));
  two_sum(p, e, rh, rl);
}

// (f - g) * (1/dx): an exact difference, then the pair product
__device__ __forceinline__ void ds_diff(float fh, float fl, float gh,
                                        float gl, float ivh, float ivl,
                                        float& rh, float& rl) {
  float dh, de;
  two_diff(fh, gh, dh, de);
  const float dl = __fsub_rn(fl, gl);
  two_sum(dh, __fadd_rn(de, dl), dh, de);
  mul_ff(dh, de, ivh, ivl, rh, rl);
}

// ---------------------------------------------------------------------
// the incident line (one block)
// ---------------------------------------------------------------------

// Einc' then Hinc' into the other buffer: ops/tfsf.py's
// _advance_einc_ds and _advance_hinc_ds, op for op (a PEC ghost beyond
// each end of the line).
__global__ void __launch_bounds__(LINE_THREADS) ds_line(const Line L) {
  const int n = L.n;
  const float *eh = L.src[0], *el = L.src[1];
  const float *hh = L.src[2], *hl = L.src[3];
  float *ne_h = L.dst[0], *ne_l = L.dst[1];
  for (int i = threadIdx.x; i < n; i += LINE_THREADS) {
    const float gh = i > 0 ? hh[i - 1] : 0.f;
    const float gl = i > 0 ? hl[i - 1] : 0.f;
    float dh, de, t1h, t1l, t2h, t2l, vh, vl;
    two_diff(hh[i], gh, dh, de);
    two_sum(dh, __fadd_rn(de, __fsub_rn(hl[i], gl)), dh, de);
    mul_ff(eh[i], el[i], L.co[0][i], L.co[1][i], t1h, t1l);
    mul_ff(dh, de, L.co[2][i], L.co[3][i], t2h, t2l);
    add_ff(t1h, t1l, -t2h, -t2l, vh, vl);
    ne_h[i] = i == 0 ? L.sh : vh;
    ne_l[i] = i == 0 ? L.sl : vl;
  }
  __syncthreads();  // the new Einc, written by other threads, is read below
  for (int i = threadIdx.x; i < n; i += LINE_THREADS) {
    const float gh = i < n - 1 ? ne_h[i + 1] : 0.f;
    const float gl = i < n - 1 ? ne_l[i + 1] : 0.f;
    float dh, de, t1h, t1l, t2h, t2l, vh, vl;
    two_diff(gh, ne_h[i], dh, de);
    two_sum(dh, __fadd_rn(de, __fsub_rn(gl, ne_l[i])), dh, de);
    mul_ff(hh[i], hl[i], L.co[4][i], L.co[5][i], t1h, t1l);
    mul_ff(dh, de, L.co[6][i], L.co[7][i], t2h, t2l);
    add_ff(t1h, t1l, -t2h, -t2l, vh, vl);
    L.dst[2][i] = vh;
    L.dst[3][i] = vl;
  }
}

// ---------------------------------------------------------------------
// the pass
// ---------------------------------------------------------------------

// CURL_TERMS of fdtd3d_tpu/layout.py: component c couples
// (derivative axis, source component, sign) = ((c+1)%3, (c+2)%3, +1)
// and ((c+2)%3, (c+1)%3, -1).
__device__ __forceinline__ constexpr int term_axis(int c, int t) {
  return (c + 1 + t) % 3;
}
__device__ __forceinline__ constexpr int term_comp(int c, int t) {
  return (c + 2 - t) % 3;
}

// A coefficient pair at a cell: a grid's words, or (GRID = false: no
// grid in the call) the scalar pair.
template <bool GRID>
__device__ __forceinline__ void pair_coef(const PairCoef& c, int64_t cell,
                                          float& h, float& l) {
  h = GRID && c.hi ? c.hi[cell] : c.vh;
  l = GRID && c.hi ? c.lo[cell] : c.vl;
}

__device__ __forceinline__ float coef(const Coef& c, int64_t cell) {
  return c.grid ? c.grid[cell] : c.val;
}

__device__ __forceinline__ float box_coef(const BoxCoef& c, int x, int j,
                                          int k, int64_t cell) {
  const bool in = c.grid && x >= c.lo[0] && x <= c.hi[0] && j >= c.lo[1] &&
                  j <= c.hi[1] && k >= c.lo[2] && k <= c.hi[2];
  return in ? c.grid[cell] : c.val;
}

// Plane of index ia inside the compact 2m-plane slab stack, or -1.
__device__ __forceinline__ int slab_plane(int ia, int n, int m) {
  return m > 0 ? (ia < m ? ia : (ia >= n - m ? ia - (n - 2 * m) : -1))
               : -1;
}

// Offset of cell (i, j, k) in the psi stack of axis a, row `row`, at
// slab plane q (a stack holds fewer than 2^31 values: the wrapper
// checks).
__device__ __forceinline__ int psi_offset(int a, int row, int q, int i,
                                          int j, int k, int n1, int n2,
                                          int n3, int m2) {
  if (a == 0) return ((row * m2 + q) * n2 + j) * n3 + k;
  if (a == 1) return ((row * n1 + i) * m2 + q) * n3 + k;
  return ((row * n1 + i) * n2 + j) * m2 + q;
}

// Index of cell (i, j, k) inside the plane of a record whose normal is
// `axis` (C order over the two other axes).
__device__ __forceinline__ int plane_index(int axis, int i, int j, int k,
                                           int n2, int n3) {
  if (axis == 0) return j * n3 + k;
  if (axis == 1) return i * n3 + k;
  return i * n2 + j;
}

// The record term at geometry cell q from the line half (lh, ll):
// ops/packed_ds.py::record_terms for one cell, op for op.
__device__ __forceinline__ void record_term(const Params& p,
                                            const float* lh,
                                            const float* ll, int q,
                                            float& th, float& tl) {
  const int i0 = p.geo_i0[q];
  const int64_t T = p.total;
  const float* g = p.geo + q;
  float ah, al, bh, bl, vh, vl;
  mul_ff(lh[i0], ll[i0], g[2 * T], g[3 * T], ah, al);          // v0 (1-w)
  mul_ff(lh[i0 + 1], ll[i0 + 1], g[0], g[T], bh, bl);          // v1 w
  add_ff(ah, al, bh, bl, vh, vl);
  mul_ff(vh, vl, g[4 * T], g[5 * T], th, tl);                  // * scale
  const float gate = g[6 * T];
  th = __fmul_rn(th, gate);
  tl = __fmul_rn(tl, gate);
}

// One family's record table in shared memory (the kernel copies it from
// the parameter block once: indexing the parameter block with a runtime
// index is slow), with the bits of each component's records, of the
// x-normal TFSF records and of the point source's record.
struct RecTable {
  int comp[MAX_REC];
  int axis[MAX_REC];
  int plane[MAX_REC];
  int off[MAX_REC];
  unsigned cbits[3];
  unsigned xbits;
  unsigned pbit;
};

__device__ __forceinline__ void copy_table(const Family& f, int tid,
                                           RecTable& rt) {
  if (tid < f.n_rec) {
    rt.comp[tid] = f.rec[tid].comp;
    rt.axis[tid] = f.rec[tid].axis;
    rt.plane[tid] = f.rec[tid].plane;
    rt.off[tid] = f.rec[tid].off;
  }
  if (tid == 0) {
    unsigned cb0 = 0u, cb1 = 0u, cb2 = 0u, xb = 0u, pb = 0u;
#pragma unroll
    for (int r = 0; r < MAX_REC; ++r) {
      if (r < f.n_rec) {
        const unsigned bit = 1u << r;
        const int c = f.rec[r].comp;
        cb0 |= c == 0 ? bit : 0u;
        cb1 |= c == 1 ? bit : 0u;
        cb2 |= c == 2 ? bit : 0u;
        if (f.rec[r].point) {
          pb |= bit;
        } else if (f.rec[r].axis == 0) {
          xb |= bit;
        }
      }
    }
    rt.cbits[0] = cb0;
    rt.cbits[1] = cb1;
    rt.cbits[2] = cb2;
    rt.xbits = xb;
    rt.pbit = pb;
  }
}

// The y- and z-normal TFSF records whose plane holds column (j, k).
__device__ __forceinline__ unsigned column_bits(const RecTable& rt,
                                                int n_rec, int j, int k) {
  unsigned bits = 0u;
  for (int r = 0; r < n_rec; ++r) {
    const int a = rt.axis[r];
    if (!((rt.pbit >> r) & 1u) && a != 0 &&
        (a == 1 ? j : k) == rt.plane[r]) {
      bits |= 1u << r;
    }
  }
  return bits;
}

// The x-normal records on plane x (the same for every thread); the point
// source's record when (x, column) is its cell.
__device__ __forceinline__ unsigned plane_bits(const RecTable& rt, int x,
                                               bool pcol) {
  unsigned bits = 0u;
  for (unsigned z = rt.xbits | rt.pbit; z; z &= z - 1) {
    const int r = __ffs(z) - 1;
    const bool point = (rt.pbit >> r) & 1u;
    bits |= rt.plane[r] == x && (pcol || !point) ? 1u << r : 0u;
  }
  return bits;
}

// acc plus the records `bits` of component c at cell (x, j, k), in table
// order: a TFSF record's term from the line half (lh, ll), the point
// source's pair.
__device__ __forceinline__ void add_records(const Params& p,
                                            const RecTable& rt,
                                            unsigned bits, int c,
                                            const float* lh,
                                            const float* ll, int x, int j,
                                            int k, float& ah, float& al) {
  for (unsigned m = bits & rt.cbits[c]; m; m &= m - 1) {
    const int r = __ffs(m) - 1;
    float th, tl;
    if ((rt.pbit >> r) & 1u) {
      th = p.pt_h;
      tl = p.pt_l;
    } else {
      record_term(p, lh, ll,
                  rt.off[r] + plane_index(rt.axis[r], x, j, k, p.n2, p.n3),
                  th, tl);
    }
    add_ff(ah, al, th, tl, ah, al);
  }
}

// Offset of family f's profile rows of axis a in the shared profiles:
// per family and axis with a slab, rows b, c, ik hi then lo of 2 m[a]
// values.
__device__ __forceinline__ int prof_offset(const Params& p, int f, int a) {
  const int msum = p.m[0] + p.m[1] + p.m[2];
  return 12 * (f * msum + (a > 0 ? p.m[0] : 0) + (a > 1 ? p.m[1] : 0));
}

// Facts of a thread's column, fixed over the march.
struct Col {
  int j, k;
  int qy, qz;     // slab plane of j and of k, -1 outside (or no CPML)
  unsigned wall;  // E components that a y or z PEC wall zeroes (bit c)
  bool ym, zm;    // j > 0, k > 0: the backward neighbour is in the domain
  bool yp, zp;    // j < n2 - 1, k < n3 - 1: the forward one is
};

// The slab term of curl term (c, a) at slab plane q: psi' = b psi + c d
// (stored into `ps2` when `store`), d' = ik d + psi'.
__device__ __forceinline__ void slab_term(const Params& p, const float* pr,
                                          const float* ps0, float* ps2,
                                          int a, int c, int q, int x,
                                          const Col& col, bool store,
                                          float& th, float& tl) {
  const int m2 = 2 * p.m[a];
  const int row = c < a ? c : c - 1;
  const int oh = psi_offset(a, row, q, x, col.j, col.k, p.n1, p.n2, p.n3,
                            m2);
  const int ol = psi_offset(a, row + 2, q, x, col.j, col.k, p.n1, p.n2,
                            p.n3, m2);
  float x1h, x1l, x2h, x2l, pnh, pnl, yh, yl;
  mul_ff(pr[q], pr[3 * m2 + q], ps0[oh], ps0[ol], x1h, x1l);
  mul_ff(pr[m2 + q], pr[4 * m2 + q], th, tl, x2h, x2l);
  add_ff(x1h, x1l, x2h, x2l, pnh, pnl);
  if (store) {
    ps2[oh] = pnh;
    ps2[ol] = pnl;
  }
  mul_ff(pr[2 * m2 + q], pr[5 * m2 + q], th, tl, yh, yl);
  add_ff(yh, yl, pnh, pnl, th, tl);
}

// Curl term t of component c at column `at` of the ring planes, plane x:
// the difference of the source family's ring planes `here` (plane x) and
// its neighbour along the term's axis (`there`: plane x - 1 for E, x + 1
// for H; a neighbouring column of `here` along y or z), the slab CPML
// of the axis where the cell lies in its slab (AX), and the sign. The
// neighbour's address lies in the ring for every thread that computes,
// so it is loaded unconditionally and the PEC ghost (0) selected: the
// three components' chains stay one basic block the compiler can
// interleave.
template <bool BACKWARD, int AX>
__device__ __forceinline__ void curl_term(const Params& p,
                                          const float* prof,
                                          const float* here,
                                          const float* there, bool thr,
                                          int at, int x, int qx,
                                          const Col& col, bool store, int c,
                                          int t, float& th, float& tl) {
  const int a = term_axis(c, t);
  const int d = term_comp(c, t);
  const float* f = here + d * NT + at;
  const int nb = a == 1 ? BZ : 1;
  const float* g =
      a == 0 ? there + d * NT + at : f + (BACKWARD ? -nb : nb);
  const bool in = a == 0 ? thr
                         : (BACKWARD ? (a == 1 ? col.ym : col.zm)
                                     : (a == 1 ? col.yp : col.zp));
  const float gh = in ? g[0] : 0.f;
  const float gl = in ? g[3 * NT] : 0.f;
  if (BACKWARD) {
    ds_diff(f[0], f[3 * NT], gh, gl, p.iv_h, p.iv_l, th, tl);
  } else {
    ds_diff(gh, gl, f[0], f[3 * NT], p.iv_h, p.iv_l, th, tl);
  }
  if ((AX >> a) & 1) {
    const int q = a == 0 ? qx : (a == 1 ? col.qy : col.qz);
    if (q >= 0) {
      slab_term(p, prof + prof_offset(p, BACKWARD ? 0 : 1, a),
                BACKWARD ? p.psE0[a] : p.psH0[a],
                BACKWARD ? p.psE2[a] : p.psH2[a], a, c, q, x, col, store, th,
                tl);
    }
  }
}

// One cell of the new E (BACKWARD) or H at column `at` of the ring
// planes, plane x, from the source family's ring planes `here` (plane x)
// and `there` (x - 1 for E, x + 1 for H); `old` the family's old pair
// words, `thr` whether `there` exists, `store` whether the cell is the
// thread's own (its psi, J and K are written). AX: the axes whose slab
// path is compiled in (bit a; 0 in the inner kernel); GRID = false
// compiles the coefficient grids, Drude J and K out. Each stage runs for
// the three components before the next (curl sums, records, Drude J or
// K, coefficient products, walls): every component sees the reference's
// operations in the reference's order, and the three independent chains
// give the compiler instructions to interleave.
template <bool BACKWARD, int AX, bool GRID>
__device__ __forceinline__ void update(const Params& p, const Family& f,
                                       const RecTable& rt,
                                       const float* prof, unsigned bits,
                                       const float* here, const float* there,
                                       bool thr, int at, int x, int qx,
                                       const Col& col, unsigned wall,
                                       int64_t cell, const float (&old)[6],
                                       bool store, float (&out)[6]) {
  float ah[3], al[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float th0, tl0, th1, tl1;
    curl_term<BACKWARD, AX>(p, prof, here, there, thr, at, x, qx, col,
                            store, c, 0, th0, tl0);
    curl_term<BACKWARD, AX>(p, prof, here, there, thr, at, x, qx, col,
                            store, c, 1, th1, tl1);
    add_ff(th0, tl0, -th1, -tl1, ah[c], al[c]);
  }
  if (bits) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      add_records(p, rt, bits, c, f.line_h, f.line_l, x, col.j, col.k,
                  ah[c], al[c]);
    }
  }
  if (BACKWARD && GRID && p.J0) {
    const int64_t vol = (int64_t)p.n1 * p.n2 * p.n3;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float jn =
          __fadd_rn(__fmul_rn(coef(p.kj[c], cell), p.J0[c * vol + cell]),
                    __fmul_rn(coef(p.bj[c], cell), old[c]));
      if (store) p.J2[c * vol + cell] = jn;
      add_f(ah[c], al[c], -jn, ah[c], al[c]);
    }
  }
  if (!BACKWARD && GRID && p.K0) {
    const int64_t vol = (int64_t)p.n1 * p.n2 * p.n3;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float kn = __fadd_rn(
          __fmul_rn(box_coef(p.km[c], x, col.j, col.k, cell),
                    p.K0[c * vol + cell]),
          __fmul_rn(box_coef(p.bm[c], x, col.j, col.k, cell), old[c]));
      if (store) p.K2[c * vol + cell] = kn;
      add_f(ah[c], al[c], kn, ah[c], al[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float ch, cl, bh, bl, t1h, t1l, t2h, t2l, vh, vl;
    pair_coef<GRID>(f.a[c], cell, ch, cl);
    pair_coef<GRID>(f.b[c], cell, bh, bl);
    mul_ff(old[c], old[3 + c], ch, cl, t1h, t1l);
    mul_ff(ah[c], al[c], bh, bl, t2h, t2l);
    if (BACKWARD) {
      add_ff(t1h, t1l, t2h, t2l, vh, vl);
      // PEC walls: tangential E vanishes on the walls of the two axes
      // other than its own (an exact 0/1 factor, as the reference's)
      const bool zero = (wall >> c) & 1u;
      vh = zero ? __fmul_rn(vh, 0.f) : vh;
      vl = zero ? __fmul_rn(vl, 0.f) : vl;
    } else {
      add_ff(t1h, t1l, -t2h, -t2l, vh, vl);
    }
    out[c] = vh;
    out[3 + c] = vl;
  }
}

// Asynchronous 4-byte copy global -> shared, and its commit groups.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One work item: the march over its x segment. AX: the axes whose CPML
// slab path is compiled in (7 in the edge kernel, 0 in the inner one,
// which the plan gives only items whose computed cells touch no slab).
// Thread (ly, lz) takes window cell (j0 - 1 + ly, k0 - 1 + lz): it loads
// the cell's old H if the cell lies in the window, computes E on the
// owned cells and the +y/+z halo row and column, and H on the owned
// cells. GRID as in update. SHARD: a shard's lo ghosts and open sides
// compiled in (the sharded builds; see the header).
template <int AX, bool GRID, bool SHARD>
__device__ __forceinline__ void march(const Params& p, int first) {
  extern __shared__ __align__(16) float ring[];
  __shared__ RecTable tab[2];
  float* hr = ring;               // old H: RING planes
  float* er = hr + RING * PL;     // old E: ERING planes
  float* nr = er + ERING * PL;    // new E: planes i, i-1
  float* prof = nr + 2 * PL;      // CPML profiles (edge kernel)

#if OVERLAP
  // the next section's kernel reads no output of this one: it may start
  // on the SMs this kernel's last blocks leave free
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
#endif
  const int tid = threadIdx.y * BZ + threadIdx.x;
  const int ly = threadIdx.y, lz = threadIdx.x;
  const int* it = p.plan + PLAN_COLS * (first + (int)blockIdx.x);
  const int j0 = it[0], k0 = it[1], ny = it[2], nz = it[3];
  const int x0 = it[4], x1 = it[5];
  const int wy = ny + 2, wz = nz + 2;  // the tile's window
  const int n1 = p.n1, n2 = p.n2, n3 = p.n3;
  Col col;
  col.j = j0 - 1 + ly;
  col.k = k0 - 1 + lz;
  const int j = col.j, k = col.k;
  const bool inside =
      ly < wy && lz < wz && j >= 0 && j < n2 && k >= 0 && k < n3;
  const bool halo_e = inside && ly >= 1 && lz >= 1;  // the new E is read
  const bool own = halo_e && ly < wy - 1 && lz < wz - 1;  // owns its cells
  const int cidx = inside ? j * n3 + k : 0;
  const int64_t pstride = (int64_t)n2 * n3;
  const int64_t vol = (int64_t)n1 * pstride;
  col.qy = slab_plane(j, n2, p.m[1]);
  col.qz = slab_plane(k, n3, p.m[2]);
  // a shard's lo ghost planes (SHARD builds only): x is the plane
  // before x0 = 0; the window's row j = -1 and column k = -1 hold the
  // y and z ghosts' cells (old H only: no E is computed there)
  const float* const G0 = SHARD ? p.glo[0] : nullptr;  // (6, n2, n3)
  const float* const G1 = SHARD ? p.glo[1] : nullptr;  // (6, n1, n3)
  const float* const G2 = SHARD ? p.glo[2] : nullptr;  // (6, n1, n2)
  const bool gy = SHARD && G1 && j == -1 && lz < wz && k >= 0 && k < n3;
  const bool gz = SHARD && G2 && k == -1 && ly < wy && j >= 0 && j < n2;
  const bool y_wall = SHARD ? (j == 0 && !p.open_lo[1]) ||
                                  (j == n2 - 1 && !p.open_hi[1])
                            : j == 0 || j == n2 - 1;
  const bool z_wall = SHARD ? (k == 0 && !p.open_lo[2]) ||
                                  (k == n3 - 1 && !p.open_hi[2])
                            : k == 0 || k == n3 - 1;
  col.wall = (y_wall || z_wall ? 1u : 0u) | (z_wall ? 2u : 0u) |
             (y_wall ? 4u : 0u);
  col.ym = j > 0 || (SHARD && G1 && j == 0);
  col.zm = k > 0 || (SHARD && G2 && k == 0);
  col.yp = j < n2 - 1;
  col.zp = k < n3 - 1;
  const bool pcol = j == p.pj && k == p.pk;
  // planes of old fields read: < lim (E and H up to x1, the halo plane)
  const int lim = min(n1, x1 + 1);

  copy_table(p.fe, tid, tab[0]);
  copy_table(p.fh, tid, tab[1]);
  if (AX != 0) {
    for (int f = 0; f < 2; ++f) {
      for (int a = 0; a < 3; ++a) {
        const float* src = (f == 0 ? p.fe : p.fh).prof[a];
        float* dst = prof + prof_offset(p, f, a);
        for (int t = tid; t < 12 * p.m[a]; t += NT) dst[t] = src[t];
      }
    }
  }
  __syncthreads();
  const unsigned cb_e = column_bits(tab[0], p.fe.n_rec, j, k);
  const unsigned cb_h = column_bits(tab[1], p.fh.n_rec, j, k);

  // old H of plane x for the window, and (e) old E for the columns that
  // compute E (thread-private slots: a thread reads only what it
  // loaded, and has used a slot's plane before it refills the slot); one
  // commit group a plane
  auto load_plane = [&](int x, bool e) {
    if (SHARD && (gy || gz) && x >= 0 && x < lim) {  // a y or z ghost cell
      const float* g = gy ? G1 + (int64_t)x * n3 + k : G2 + (int64_t)x * n2 + j;
      const int64_t gs = gy ? (int64_t)n1 * n3 : (int64_t)n1 * n2;
      const int s = (x & (RING - 1)) * PL + tid;
#pragma unroll
      for (int w = 0; w < 6; ++w) cp_async4(hr + s + w * NT, g + w * gs);
      return;
    }
    if (x >= lim || !inside) return;
    const int s = (x & (RING - 1)) * PL + tid;
    if (SHARD && x < 0) {  // the x ghost plane, before x0 = 0
#pragma unroll
      for (int w = 0; w < 6; ++w) {
        cp_async4(hr + s + w * NT, G0 + w * pstride + cidx);
      }
      return;
    }
    const int64_t off = (int64_t)x * pstride + cidx;
#pragma unroll
    for (int w = 0; w < 6; ++w) {
      cp_async4(hr + s + w * NT, p.H0 + w * vol + off);
    }
    if (e && halo_e) {
      const int se = (x % ERING) * PL + tid;
#pragma unroll
      for (int w = 0; w < 6; ++w) {
        cp_async4(er + se + w * NT, p.E0 + w * vol + off);
      }
    }
  };
  if (x0 > 0 || (SHARD && G0)) load_plane(x0 - 1, false);  // H, read by E(x0)
#pragma unroll
  for (int q = 0; q < PIPE; ++q) {
    load_plane(x0 + q, true);
    cp_commit();
  }

  for (int i = x0; i <= x1; ++i) {
    load_plane(i + PIPE, true);
    cp_commit();
    cp_wait<PIPE>();
    __syncthreads();
    const int r_i = (i & (RING - 1)) * PL;
    const int r_m = ((i - 1) & (RING - 1)) * PL;
    const int e_i = (i % ERING) * PL;
    const int s_i = (i & 1) * PL;
    const int s_m = ((i + 1) & 1) * PL;

    // phase E(i): the new E on the owned columns and the +y/+z halo
    if (i < n1 && halo_e) {
      const int64_t c_at = (int64_t)i * pstride + cidx;
      const bool store = own && i < x1;
      float old[6], out[6];
#pragma unroll
      for (int w = 0; w < 6; ++w) old[w] = er[e_i + w * NT + tid];
      const unsigned bits = cb_e | plane_bits(tab[0], i, pcol);
      const bool x_wall = SHARD ? (i == 0 && !p.open_lo[0]) ||
                                      (i == n1 - 1 && !p.open_hi[0])
                                : i == 0 || i == n1 - 1;
      const unsigned wall = col.wall | (x_wall ? 6u : 0u);
      update<true, AX, GRID>(p, p.fe, tab[0], prof, bits, hr + r_i, hr + r_m,
                             i > 0 || (SHARD && G0), tid, i,
                             slab_plane(i, n1, p.m[0]), col, wall, c_at, old,
                             store, out);
#pragma unroll
      for (int w = 0; w < 6; ++w) {
        nr[s_i + w * NT + tid] = out[w];
        if (store) p.E2[w * vol + c_at] = out[w];
      }
    }

    // phase H(i-1): the new H on the owned columns, from the new E of
    // plane i-1 (this column and its +y, +z neighbours: written in the
    // iteration before, published by this iteration's barrier) and of
    // plane i (this column only: written just above by this thread), so
    // it needs no barrier of its own
    const int xa = i - 1;
    if (xa >= x0 && own) {
      const int64_t c_at = (int64_t)xa * pstride + cidx;
      float old[6], out[6];
#pragma unroll
      for (int w = 0; w < 6; ++w) old[w] = hr[r_m + w * NT + tid];
      const unsigned bits = cb_h | plane_bits(tab[1], xa, pcol);
      update<false, AX, GRID>(p, p.fh, tab[1], prof, bits, nr + s_m, nr + s_i,
                              xa < n1 - 1, tid, xa, slab_plane(xa, n1, p.m[0]),
                              col, 0u, c_at, old, true, out);
#pragma unroll
      for (int w = 0; w < 6; ++w) p.H2[w * vol + c_at] = out[w];
    }
  }
  cp_wait<0>();  // the last groups are empty; none stays in flight
}

template <int AX, bool GRID, int MINB, bool SHARD>
__global__ void __launch_bounds__(NT, MINB)
    ds_section(const Params p, int first) {
  march<AX, GRID, SHARD>(p, first);
}

// Dynamic shared memory of a block: the old H and E rings, the new E
// ring, the CPML profiles.
static int smem_bytes(int msum) {
  return ((RING + ERING + 2) * PL + 24 * msum) *
         static_cast<int>(sizeof(float));
}

typedef void (*Kernel)(const Params, int);

// The plan's sections, in launch order (ops/packed_ds.py::SECTIONS): the
// items whose computed cells touch a CPML slab, then the others; one
// launch of each, in a build with the coefficient grids and Drude J (a
// call that has any) or one without; [sharded][grid][section]: the
// unsharded builds, then a shard's (lo ghosts and open sides).
static const Kernel kKernels[2][2][SECTIONS] = {
    {{ds_section<7, false, EDGE_BLOCKS, false>,
      ds_section<0, false, INNER_BLOCKS, false>},
     {ds_section<7, true, EDGE_BLOCKS, false>,
      ds_section<0, true, INNER_BLOCKS, false>}},
    {{ds_section<7, false, EDGE_BLOCKS, true>,
      ds_section<0, false, INNER_BLOCKS, true>},
     {ds_section<7, true, EDGE_BLOCKS, true>,
      ds_section<0, true, INNER_BLOCKS, true>}}};

// ---------------------------------------------------------------------
// a shard's hi-edge H (the sharded variant)
// ---------------------------------------------------------------------

// Blocks of the hi-edge launch on each face of a shard with an upper
// neighbour: x (the plane n1 - 1, tiles of (BY - 1) x (BZ - 1) cells),
// y (the row n2 - 1 below the x face: BY / 2 planes of BZ - 1 cells a
// block) and z (the column n3 - 1 below both: BZ / 2 planes of BY - 1
// cells a block). Each cell of the union lies on one face.
struct EdgeFaces {
  int n[3];       // blocks of each face
  int nx, ny;     // planes x < nx carry the y and z faces; rows j < ny z's
};

static EdgeFaces edge_faces(const Params& p) {
  EdgeFaces f;
  f.nx = p.n1 - (p.open_hi[0] ? 1 : 0);
  f.ny = p.n2 - (p.open_hi[1] ? 1 : 0);
  const int ty = (p.n2 + BY - 2) / (BY - 1), tz = (p.n3 + BZ - 2) / (BZ - 1);
  f.n[0] = p.open_hi[0] ? ty * tz : 0;
  f.n[1] = p.open_hi[1] ? ((f.nx + BY / 2 - 1) / (BY / 2)) * tz : 0;
  f.n[2] = p.open_hi[2]
               ? ((f.nx + BZ / 2 - 1) / (BZ / 2)) * ((f.ny + BY - 2) / (BY - 1))
               : 0;
  return f;
}

// The new E pair word w at (x, j, k), where x, j or k may be one past the
// shard's hi edge: there the upper neighbour's ghost plane, else 0.
__device__ __forceinline__ float edge_e(const Params& p, int w, int x, int j,
                                        int k) {
  const int n1 = p.n1, n2 = p.n2, n3 = p.n3;
  const bool in0 = x < n1, in1 = j < n2, in2 = k < n3;
  if (in0 && in1 && in2) {
    return p.E2[((int64_t)w * n1 + x) * n2 * (int64_t)n3 +
                (int64_t)j * n3 + k];
  }
  if (x == n1 && in1 && in2 && p.ghi[0]) {
    return p.ghi[0][((int64_t)w * n2 + j) * n3 + k];
  }
  if (j == n2 && in0 && in2 && p.ghi[1]) {
    return p.ghi[1][((int64_t)w * n1 + x) * n3 + k];
  }
  if (k == n3 && in0 && in1 && p.ghi[2]) {
    return p.ghi[2][((int64_t)w * n1 + x) * n2 + j];
  }
  return 0.f;
}

// The new H (with its psi and K) of every cell on a shard's hi-edge
// planes, computed whole by the pass's own cell code from the source
// buffers, the new E and the hi ghosts. A block lays its cells' new E out
// as the pass's ring planes do (`here`: the cell's plane, its +y
// neighbour BZ words on, its +z one word on; `there`: plane x + 1 at the
// same slot), so update<false, 7, GRID> reads them as in the march: on
// the x face thread (ly, lz) takes cell (n1 - 1, j0 + ly, k0 + lz); on
// the y face the thread pair (2g, lz), (2g + 1, lz) takes cell (x0 + g,
// n2 - 1, k0 + lz), the odd row holding its +y neighbour; on the z face
// the pair (ly, 2g), (ly, 2g + 1) cell (x0 + g, j0 + ly, n3 - 1).
template <bool GRID>
__global__ void __launch_bounds__(NT, 1)
    ds_hi_edge(const Params p, EdgeFaces f) {
  extern __shared__ __align__(16) float ring[];
  __shared__ RecTable tab;
  float* here = ring;
  float* there = here + PL;
  float* prof = there + PL;
  const int tid = threadIdx.y * BZ + threadIdx.x;
  const int ly = threadIdx.y, lz = threadIdx.x;
  const int n1 = p.n1, n2 = p.n2, n3 = p.n3;
  int b = blockIdx.x, face = 0;
  while (face < 2 && b >= f.n[face]) b -= f.n[face++];
  int x, j, k;
  bool compute;
  if (face == 0) {
    const int tz = (n3 + BZ - 2) / (BZ - 1);
    x = n1 - 1;
    j = (b / tz) * (BY - 1) + ly;
    k = (b % tz) * (BZ - 1) + lz;
    compute = ly < BY - 1 && lz < BZ - 1 && j < n2 && k < n3;
  } else if (face == 1) {
    const int tz = (n3 + BZ - 2) / (BZ - 1);
    x = (b / tz) * (BY / 2) + (ly >> 1);
    j = n2 - 1 + (ly & 1);
    k = (b % tz) * (BZ - 1) + lz;
    compute = !(ly & 1) && lz < BZ - 1 && x < f.nx && k < n3;
  } else {
    const int ty = (f.ny + BY - 2) / (BY - 1);
    x = (b / ty) * (BZ / 2) + (lz >> 1);
    j = (b % ty) * (BY - 1) + ly;
    k = n3 - 1 + (lz & 1);
    compute = !(lz & 1) && ly < BY - 1 && x < f.nx && j < f.ny;
  }
#pragma unroll
  for (int w = 0; w < 6; ++w) {
    here[w * NT + tid] = edge_e(p, w, x, j, k);
    there[w * NT + tid] = edge_e(p, w, x + 1, j, k);
  }
  copy_table(p.fh, tid, tab);
  for (int fam = 0; fam < 2; ++fam) {
    for (int a = 0; a < 3; ++a) {
      const float* src = (fam == 0 ? p.fe : p.fh).prof[a];
      float* dst = prof + prof_offset(p, fam, a);
      for (int t = tid; t < 12 * p.m[a]; t += NT) dst[t] = src[t];
    }
  }
  __syncthreads();
  if (!compute) return;
  Col col;
  col.j = j;
  col.k = k;
  col.qy = slab_plane(j, n2, p.m[1]);
  col.qz = slab_plane(k, n3, p.m[2]);
  col.wall = 0u;
  col.ym = j > 0;
  col.zm = k > 0;
  col.yp = j < n2 - 1 || p.open_hi[1];
  col.zp = k < n3 - 1 || p.open_hi[2];
  const int64_t vol = (int64_t)n1 * n2 * n3;
  const int64_t cell = ((int64_t)x * n2 + j) * n3 + k;
  float old[6], out[6];
#pragma unroll
  for (int w = 0; w < 6; ++w) old[w] = p.H0[w * vol + cell];
  const unsigned bits = column_bits(tab, p.fh.n_rec, j, k) |
                        plane_bits(tab, x, false);
  update<false, 7, GRID>(p, p.fh, tab, prof, bits, here, there,
                         x < n1 - 1 || p.open_hi[0], tid, x,
                         slab_plane(x, n1, p.m[0]), col, 0u, cell, old, true,
                         out);
#pragma unroll
  for (int w = 0; w < 6; ++w) p.H2[w * vol + cell] = out[w];
}

typedef void (*EdgeKernel)(const Params, EdgeFaces);
static const EdgeKernel kEdge[2] = {ds_hi_edge<false>, ds_hi_edge<true>};

static int edge_smem_bytes(int msum) {
  return (2 * PL + 24 * msum) * static_cast<int>(sizeof(float));
}

static int g_smem_most = 0;  // shared memory a block may have (opt-in)

// The builds with grids: any coefficient is a grid, or Drude J or K runs.
static bool uses_grids(const Params& p) {
  bool grid = p.J0 != nullptr || p.K0 != nullptr;
  for (int c = 0; c < 3; ++c) {
    grid = grid || p.fe.a[c].hi || p.fe.b[c].hi || p.fh.a[c].hi ||
           p.fh.b[c].hi;
  }
  return grid;
}

// Lets both kernels take the largest shared memory a call may need and
// prefer shared memory over L1, once.
static cudaError_t set_attributes() {
  static bool done = false;
  if (done) return cudaSuccess;
  int dev = 0, most = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return err;
  g_smem_most = most;
  const int want = smem_bytes(MAX_SLAB_SUM);
  for (int q = 0; q < 4 * SECTIONS + 2; ++q) {
    const void* k =
        q < 4 * SECTIONS
            ? reinterpret_cast<const void*>(
                  kKernels[q / (2 * SECTIONS)][(q / SECTIONS) % 2]
                          [q % SECTIONS])
            : reinterpret_cast<const void*>(kEdge[q - 4 * SECTIONS]);
    const int need = q < 4 * SECTIONS ? want : edge_smem_bytes(MAX_SLAB_SUM);
    cudaFuncAttributes a;
    err = cudaFuncGetAttributes(&a, k);
    if (err != cudaSuccess) return err;
    const int room = most - static_cast<int>(a.sharedSizeBytes);
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               need < room ? need : room);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(
          k, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    }
    if (err != cudaSuccess) return err;
  }
  done = true;
  return cudaSuccess;
}

// The test-only probes: the kernel's own two_sum and two_prod on n
// pairs; the record term of every geometry cell (E records' cells,
// which sample fe's line half, before `h_first`, then H records').
__global__ void eft_probe(const float* a, const float* b, float* s,
                          float* e, float* pr, float* pe, int n) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= n) return;
  two_sum(a[x], b[x], s[x], e[x]);
  two_prod(a[x], b[x], pr[x], pe[x]);
}

__global__ void terms_probe(const Params p, int h_first, float* out) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= p.total) return;
  const Family& f = q < h_first ? p.fe : p.fh;
  float th, tl;
  record_term(p, f.line_h, f.line_l, q, th, tl);
  out[q] = th;
  out[p.total + q] = tl;
}

extern "C" {

int fdtd_ds_params_size() { return static_cast<int>(sizeof(Params)); }

int fdtd_ds_line_size() { return static_cast<int>(sizeof(Line)); }

// The geometry the plan must follow: out = {owned y extent of a tile,
// owned z extent}.
int fdtd_ds_tile(int* out) {
  out[0] = BY - 2;
  out[1] = BZ - 2;
  return 0;
}

// Per section kernel (the builds without grids, then those with; the
// unsharded builds, then the sharded ones), four ints: registers a
// thread, local (spill) bytes a thread, resident blocks an SM at the
// shared memory of CPML of 8 planes on every axis, static shared bytes.
int fdtd_ds_occupancy(int* out) {
  cudaError_t err = set_attributes();
  for (int q = 0; q < 4 * SECTIONS && err == cudaSuccess; ++q) {
    const Kernel k =
        kKernels[q / (2 * SECTIONS)][(q / SECTIONS) % 2][q % SECTIONS];
    cudaFuncAttributes a;
    err = cudaFuncGetAttributes(&a, k);
    int blocks = 0;
    const int smem = smem_bytes(24);
    if (err == cudaSuccess &&
        smem + static_cast<int>(a.sharedSizeBytes) <= g_smem_most) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, k, NT, smem);
    }
    out[4 * q] = a.numRegs;
    out[4 * q + 1] = static_cast<int>(a.localSizeBytes);
    out[4 * q + 2] = blocks;
    out[4 * q + 3] = static_cast<int>(a.sharedSizeBytes);
  }
  return static_cast<int>(err);
}

int fdtd_ds_line(const Line* l, void* stream) {
  if (l->n < 2) return static_cast<int>(cudaErrorInvalidValue);
  ds_line<<<1, LINE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(*l);
  return static_cast<int>(cudaGetLastError());
}

int fdtd_ds_pass(const Params* p, void* stream) {
  cudaError_t err = set_attributes();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int msum = p->m[0] + p->m[1] + p->m[2];
  if (msum > MAX_SLAB_SUM || p->n_item[0] < 0 || p->n_item[1] < 0) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const bool grid = uses_grids(*p);
  bool shard = false;  // the sharded builds, where a shard has a neighbour
  for (int a = 0; a < 3; ++a) {
    shard = shard || p->glo[a] || p->open_lo[a] || p->open_hi[a];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int q = 0; q < SECTIONS; ++q) {  // in the plan's order
    const int n = p->n_item[q];
    int first = q == 0 ? 0 : p->n_item[0];
    if (n > 0) {
      void* args[] = {const_cast<Params*>(p), &first};
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(n);
      cfg.blockDim = dim3(BZ, BY);
      cfg.dynamicSmemBytes = smem_bytes(msum);
      cfg.stream = s;
      // the inner kernel may overlap the edge one (programmatic dependent
      // launch): they write disjoint cells and read only the source
      // buffers and the line, which the work before the edge kernel
      // wrote; the call's first kernel waits for all earlier work on the
      // stream, as every later launch on it waits for both
      cudaLaunchAttribute attr;
      attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
      attr.val.programmaticStreamSerializationAllowed = 1;
      cfg.attrs = &attr;
      cfg.numAttrs = OVERLAP && first > 0 ? 1 : 0;
      err = cudaLaunchKernelExC(
          &cfg,
          reinterpret_cast<const void*>(kKernels[shard][grid][q]),
          args);
      if (err == cudaSuccess) err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return static_cast<int>(cudaSuccess);
}

// A shard's hi-edge H: one launch over the faces where it has an upper
// neighbour (none: nothing is launched). It must follow the pass of
// every shard and the exchange of the hi ghosts (Params.ghi).
int fdtd_ds_hi_edge(const Params* p, void* stream) {
  cudaError_t err = set_attributes();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int msum = p->m[0] + p->m[1] + p->m[2];
  if (msum > MAX_SLAB_SUM) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const EdgeFaces f = edge_faces(*p);
  const int blocks = f.n[0] + f.n[1] + f.n[2];
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  kEdge[uses_grids(*p)]<<<blocks, dim3(BZ, BY), edge_smem_bytes(msum),
                          static_cast<cudaStream_t>(stream)>>>(*p, f);
  return static_cast<int>(cudaGetLastError());
}

int fdtd_ds_terms(const Params* p, int h_first, float* out, void* stream) {
  const int n = static_cast<int>(p->total);
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  terms_probe<<<(n + 255) / 256, 256, 0,
                static_cast<cudaStream_t>(stream)>>>(*p, h_first, out);
  return static_cast<int>(cudaGetLastError());
}

int fdtd_ds_eft_probe(const float* a, const float* b, float* s, float* e,
                      float* pr, float* pe, int n, void* stream) {
  eft_probe<<<(n + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, s, e, pr, pe, n);
  return static_cast<int>(cudaGetLastError());
}

const char* fdtd_ds_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
