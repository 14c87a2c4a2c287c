// Recompute-fused pass of the 3D Yee scheme, for Hopper (sm_90a): one
// x-marching pass computes a whole step, E and then H from that E.
//
// Replaces the Pallas TPU kernel
// fdtd3d_tpu/ops/pallas_fused.py::make_fused_eh_step (builder :310,
// kernel body :423, pallas_call :709) for 3D real float32 and bf16
// storage, unsharded,
// together with what the reference's step patches on after it (the x
// slab CPML post-pass, the TFSF face patches, the point source and the
// H corrections of those patches); the step around it is
// fdtd3d_torch/ops/pallas_fused.py.
//
// What one call computes, on per-component arrays (n1, n2, n3)
// float32, C order, z innermost (the reference's unpacked state), out
// of place (old arrays read, fresh arrays written):
//   E' = ca E + cb (curl_b H + CPML terms + records - J' + drive),
//   J' = kj J + bj E,
//   H' = da H - db (curl_f E' + CPML terms + records + K'),
//   K' = km K + bm H   (magnetic Drude, pallas_fused.py:597)
// Each curl term is s * dfa, plus, on a CPML slab of its axis (x, y or
// z alike), s * ((ik - 1) dfa + psi') with psi' = b psi + c dfa on the
// compact slab psi (2m planes along the axis). Each TFSF record adds its
// plane term (ops/tfsf.py::record_terms, one f32 vector for both
// families) into the accumulator at its plane before the coefficient
// multiply, in table order; the point source adds `drive` (ps_amp times
// the waveform) after the Drude current; the H half adds K' after its
// records (the E half takes J' off). PEC zero ghosts outside the
// domain, per-cell or scalar coefficients, PEC walls on tangential E.
// H is computed from the final E, so nothing is patched afterwards.
// bf16 storage (Grid.bf16, csrc/storage.cuh): E and H are bf16 words in
// device memory, widened to float where they enter the rings; E' is
// rounded to bf16 where it is stored, and H' is computed from the
// unrounded E' of the new-E ring, as the reference's fused kernel keeps
// new_e for its H update (pallas_fused.py:566-603). psi, J, the records
// and the coefficients stay float32.
// Every operation is the plain PyTorch version's, in its order
// (pallas_fused.fused_eh_plain), and the library is built with
// --fmad=false: no product is contracted into an FMA, so a cell's value
// does not depend on the section kernel that computes it and the
// kernel reproduces the plain version's bits.
//
// The march. A thread block owns a work item of the host's plan
// (ops/pallas_fused.py::plan_items): a (y, z) tile of at most (BY - 2)
// rows by BZ columns over an x segment [x0, x1), the z cuts at multiples
// of BZ. Its window is the tile plus a 1-cell halo on each side: warp w
// takes the BZ owned columns of window row w (every owned row is whole
// aligned 128-byte lines of each array), and the last lanes of the block
// take the two halo columns of every row. The block marches x from x0
// to x1 and at plane i computes E(i) and then H(i-1), with one barrier a
// plane: H(i-1) reads E(i) only at its own cell, which the same thread
// has just written, and E(i-1) at its +y and +z neighbours', which the
// plane's barrier published. E reads old H at y-1, z-1 and x-1
// (backward differences) and H reads the new E at y+1, z+1 and x+1
// (forward), so E is computed on the owned cells, the +y row, the +z
// column and plane x1 (redundantly, with their own psi, J, records and
// walls; the halo's psi and J are never stored), and H on the owned
// cells only. The old H of planes i and i-1 and the old E of plane i
// stream into shared-memory plane rings PIPE planes ahead of the march
// by cp.async (4 bytes a thread and word: each thread copies its own
// cell, and the barrier that opens a plane, which the march needs
// anyway, publishes it); the new E of planes i and i-1 sits in a
// two-plane ring (a third slot is not needed: the slot E(i+1) overwrites
// was last read by H(i-1) before the barrier of plane i+1). Psi, J,
// records and coefficient grids are read from device memory by the
// thread that needs them.
//
// Sections. The plan classes an item by the cells it computes, its hi
// E halo included: SLAB if one lies in a CPML slab, SOURCE if one lies
// on a record's plane or is the point source's cell, PLAIN otherwise.
// Each section is one kernel built from the one march (kKernels): the
// SLAB items of several axes (the slab path of all three compiled in),
// of x only, of y only, of z only, the SOURCE items (records and point
// source compiled in, no slab code) and the PLAIN ones (neither). So a
// halo cell always runs the code its owner runs. Each section starts on
// the SMs its predecessor leaves free (programmatic dependent launch):
// the sections write disjoint cells and read only the old state, the
// record terms and the coefficients. Coefficient grids are read only
// by the items whose computed cells reach the box outside which every
// grid holds its background value (the plan row's flag; the others take
// the background from the parameter block), so a uniform branch a block
// replaces the grid loads.
//
// The design for the H100. Each choice against its alternative in one
// call of scripts/fused_variants.py (ms of the pass's kernels at 256^3
// on vacuum3D_tfsf's state / on the Mie example at 512^3; NVIDIA H100
// 80GB HBM3, 700 W; PERF.md). As built: 0.595 / 4.140-4.143.
// 1. Whole aligned rows. The first design (30 x 30 owned cells in 32 x
//    32 threads, rows at any z offset straddling 128-byte lines) took
//    0.729-0.736 / 4.99-5.04, its stores alone 0.505 / 3.62, and 0.161 /
//    1.17 with each warp's stores moved onto one aligned line (earlier
//    calls of the same script); BZ = 32 owned columns at multiples of 32,
//    the halo columns on extra lanes, take the stores alone to 0.143 /
//    1.09.
// 2. Occupancy: 12-row windows (10 x 32 owned, 408 threads), three
//    blocks an SM at 48 registers (the general edge kernel spills 64
//    bytes), against 30 rows one an SM 0.664 / 4.44, 16 rows two an SM
//    0.617 / 4.31, 10 rows four an SM 0.597 / 4.18, 8 rows four an SM
//    0.620 / 4.26, the edge kernels two an SM without spills 0.653 /
//    4.46.
// 3. One barrier a plane (a second between the phases: 0.604 / 4.19);
//    old fields by cp.async (ordinary loads: 0.641 / 4.33) one plane
//    ahead (two: 0.597 / 4.15). A bf16 cell is a 2-byte word, below
//    cp.async's 4 bytes, and the halo columns make a tile's rows start
//    at odd columns: the bf16 build loads each thread's words of the
//    next plane into registers at the top of an iteration and widens
//    them into the float rings at its end, after the plane's phases.
// 4. Sections: edge kernels specialised by slab axis (one general edge
//    kernel: 0.646 / 4.42; every item in it: 0.740 / 5.19); each section
//    may start while the one before ends (programmatic dependent launch;
//    without: 0.762 / 4.34); x segments of 16 planes (8: 0.615 / 4.35;
//    24: 0.597 / 4.14; 32: 0.608 / 4.15); y and z cut whole (band by
//    band, with narrow band tiles: 0.736 / 4.82).
// 5. No FMA contraction: contracted 0.594 / 4.13, but a halo cell could
//    then differ from its owner's bits.
//
// What bounds it on the card: memory bytes. A call must read E, H (and
// J, K) once and write E', H' (and J', K') once, 12 field volumes (48 B/cell,
// 24 B/cell more for each of J and K)
// plus psi of every slab axis, the coefficient grids inside their box
// and the record terms, against the two-pass step's 18 volumes; ~60
// flops a cell. The halo re-reads (1.28 cells loaded a cell owned at 10
// x 32 owned in a 12 x 34 window, E computed on 1.13 and on one extra
// plane a segment) mostly hit L2. Timing-only builds at 256^3 / 512^3
// (scripts/fused_variants.py) split the pass: loads and stores alone
// 0.448 / 3.44 (loads alone 0.243 / 1.83, stores alone 0.143 / 1.09,
// barriers and rings 0.031 / 0.20), the arithmetic 0.15 / 0.70 on top.
//
// Build knobs (-D): BY (window rows), BZ (owned columns, a multiple of
// 32), PIPE, INNER_BLOCKS, EDGE_BLOCKS, OVERLAP. The timing-only builds
// are source patches of scripts/fused_variants.py, not knobs of this
// file.
//
// Every kernel has a float and a bf16 build (kKernels). Offsets are
// 64-bit across planes (32-bit inside a plane). Every entry
// returns cudaGetLastError() (or the first error) so the caller can
// raise on a refused launch.

#include "family_cell.cuh"

#define PLAN_COLS 8     // ints a plan row: j0, k0, ny, nz, x0, x1, class, grid
#define SECTIONS 6      // edge, edge_x, edge_y, edge_z, source, inner
#define MAX_SLAB_SUM 256  // CPML planes a side summed over the axes
#ifndef BZ
#define BZ 32  // owned z columns of a tile: one warp a window row
#endif
#ifndef BY
#define BY 12  // window rows of a tile, the y halo included
#endif
#ifndef PIPE
#define PIPE 1  // planes of old fields in flight ahead of the march
#endif
#ifndef INNER_BLOCKS
#define INNER_BLOCKS 3  // resident blocks an SM of the source and inner kernels
#endif
#ifndef EDGE_BLOCKS
#define EDGE_BLOCKS 3  // resident blocks an SM of the edge kernels
#endif
#ifndef OVERLAP
#define OVERLAP 1  // a section's kernel may start while the one before ends
#endif
#define RW (BZ + 2)   // a ring row: the owned columns and a halo column a side
#define RP (RW * BY)  // a ring plane of one component
#define PL (3 * RP)   // floats of one ring plane: three components
#define NT (BZ * BY + 2 * BY)  // threads: the owned columns' warps, then
                               // the two halo columns' lanes
// an H ring slot is refilled PIPE planes ahead, while other threads of
// the iteration before may still read the planes i-1 and i-2; an old-E
// slot is read only by the thread that loads it, which has used its
// plane before it refills the slot
#define RING ((PIPE + 3) <= 4 ? 4 : 8)
#define ERING (PIPE + 1)
#if PIPE < 1 || PIPE > 5
#error "PIPE must lie in [1, 5]"
#endif

struct Params {
  FamOps e;               // E: old and fresh fields, psi of every slab
  FamOps h;               // axis (x too), profiles, ca/cb; H: da/db
  Drude dr;               // Drude J, or null pointers
  Drude dk;               // magnetic Drude K (km, bm), or null pointers
  Grid g;                 // m[a]: slab planes a side of every CPML axis
  const float* terms;     // (total,) record terms, or nullptr
  const int* plan;        // (items, PLAN_COLS) work items, by section
  Rec rec[2][MAX_REC];    // E records, then H records, in table order
  int n_rec[2];
  int pc, pi, pj, pk;     // the point source's component (-1: none), cell
  float drive;            // ps_amp * waveform(t)
  int n_item[SECTIONS];   // items of each section, in launch order
};

// Offset of cell (i, j, k) in a compact slab psi of axis a at slab plane
// q: (2m, n2, n3), (n1, 2m, n3) or (n1, n2, 2m).
__device__ __forceinline__ int64_t psi_offset(int a, int q, int i, int j,
                                              int k, int n2, int n3,
                                              int m2) {
  if (a == 0) return (static_cast<int64_t>(q) * n2 + j) * n3 + k;
  if (a == 1) return (static_cast<int64_t>(i) * m2 + q) * n3 + k;
  return (static_cast<int64_t>(i) * n2 + j) * m2 + q;
}

// Offset of family f's profile rows of axis a in the shared profiles:
// per family and axis with a slab, rows b, c, 1/kappa of 2 m[a] values.
__device__ __forceinline__ int prof_offset(const Params& p, int f, int a) {
  const int msum = p.g.m[0] + p.g.m[1] + p.g.m[2];
  return 6 * (f * msum + (a > 0 ? p.g.m[0] : 0) + (a > 1 ? p.g.m[1] : 0));
}

// A coefficient at a cell: its grid where the item reads grids (`grid`),
// else its scalar (for an item outside the grids' box, the grid's
// background value).
__device__ __forceinline__ float coef_at(const Coef& c, bool grid,
                                         int64_t cell) {
  return grid && c.grid ? c.grid[cell] : c.val;
}

// Facts of a thread's column, fixed over the march.
struct Col {
  int j, k;
  int qy, qz;     // slab plane of j and of k, -1 outside (or no CPML)
  unsigned wall;  // E components that a y or z PEC wall zeroes (bit c)
  bool ym, zm;    // j > 0, k > 0: the backward neighbour is in the domain
  bool yp, zp;    // j < n2 - 1, k < n3 - 1: the forward one is
};

// One cell of the new E (BACKWARD) or H at column `at` of the ring
// planes, plane x, from the source family's ring planes `here` (plane x)
// and `there` (x - 1 for E, x + 1 for H; `thr` whether it lies in the
// domain). `old` the family's old values, `store` whether the cell is
// the thread's own (its psi and J are written), `bits` the records on
// the cell, `pcell` whether it is the point source's cell. AX: the axes
// whose slab path is compiled in (bit a); SRC: records and the point
// source compiled in. Each stage runs for the three components before
// the next, so the three independent chains interleave.
template <bool BACKWARD, int AX, bool SRC>
__device__ __forceinline__ void update(const Params& p, const RecTable* rt,
                                       const float* prof, unsigned bits,
                                       bool pcell, const float* here,
                                       const float* there, bool thr, int at,
                                       int x, int qx, const Col& col,
                                       unsigned wall, bool grid,
                                       int64_t cell, const float (&old)[3],
                                       bool store, float (&out)[3]) {
  const FamOps& f = BACKWARD ? p.e : p.h;
  const int n2 = p.g.n[1], n3 = p.g.n[2];
  const float iv = p.g.inv_dx;
  float acc[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int a = term_axis(c, t);
      const int d = term_comp(c, t);
      const float* g = here + d * RP + at;
      // the neighbour's address lies in the ring for every computing
      // thread: loaded unconditionally, the PEC ghost (0) selected
      const float* h = a == 0 ? there + d * RP + at
                              : g + (BACKWARD ? -1 : 1) * (a == 1 ? RW : 1);
      const bool in = a == 0 ? thr
                             : (BACKWARD ? (a == 1 ? col.ym : col.zm)
                                         : (a == 1 ? col.yp : col.zp));
      const float nb = in ? h[0] : 0.f;
      const float dfa = BACKWARD ? (g[0] - nb) * iv : (nb - g[0]) * iv;
      float term = t == 0 ? dfa : -dfa;
      if ((AX >> a) & 1) {
        const int q = a == 0 ? qx : (a == 1 ? col.qy : col.qz);
        if (q >= 0) {
          const int m2 = 2 * p.g.m[a];
          const float* pr = prof + prof_offset(p, BACKWARD ? 0 : 1, a);
          const int64_t off = psi_offset(a, q, x, col.j, col.k, n2, n3, m2);
          const float psi = pr[q] * f.psi_in[c][t][off] + pr[m2 + q] * dfa;
          if (store) f.psi_out[c][t][off] = psi;
          const float fix = (pr[2 * m2 + q] - 1.f) * dfa + psi;
          term = term + (t == 0 ? fix : -fix);
        }
      }
      acc[c] = t == 0 ? term : acc[c] + term;
    }
  }
  if (SRC && bits) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      for (unsigned m = bits & rt->cbits[c]; m; m &= m - 1) {
        const int r = __ffs(m) - 1;
        acc[c] = acc[c] + p.terms[rt->off[r] + plane_index(rt->axis[r], x,
                                                            col.j, col.k, n2,
                                                            n3)];
      }
    }
  }
  if (BACKWARD && p.dr.Jin[0] != nullptr) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float jn = coef_at(p.dr.kj[c], grid, cell) * p.dr.Jin[c][cell] +
                       coef_at(p.dr.bj[c], grid, cell) * old[c];
      if (store) p.dr.Jout[c][cell] = jn;
      acc[c] = acc[c] - jn;
    }
  }
  if (!BACKWARD && p.dk.Jin[0] != nullptr) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float kn = coef_at(p.dk.kj[c], grid, cell) * p.dk.Jin[c][cell] +
                       coef_at(p.dk.bj[c], grid, cell) * old[c];
      if (store) p.dk.Jout[c][cell] = kn;
      acc[c] = acc[c] + kn;
    }
  }
  if (BACKWARD && SRC && pcell) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (c == p.pc) acc[c] = acc[c] + p.drive;
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float a = coef_at(f.a[c], grid, cell) * old[c];
    const float b = coef_at(f.b[c], grid, cell) * acc[c];
    if (BACKWARD) {
      // PEC walls: tangential E vanishes on the walls of the two axes
      // other than its own
      out[c] = (wall >> c) & 1u ? 0.f : a + b;
    } else {
      out[c] = a - b;
    }
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

// One work item: the march over its x segment. A thread takes window
// cell (wy, wz), grid cell (j0 - 1 + wy, k0 - 1 + wz), and ring index
// wy * RW + wz: warp w the owned columns 1..BZ of window row w, the last
// lanes column 0 and column BZ + 1 of every row. It loads the cell's old
// H if the cell lies in the window, computes E on the owned cells and
// the +y/+z halo row and column, and H on the owned cells.
template <int AX, bool SRC, typename T>
__device__ __forceinline__ void march(const Params& p, int first) {
  constexpr bool BF = sizeof(T) == 2;
  extern __shared__ __align__(16) float ring[];
  __shared__ RecTable tab[2];
  float* hr = ring;               // old H: RING planes
  float* er = hr + RING * PL;     // old E: ERING planes
  float* nr = er + ERING * PL;    // new E: planes i, i-1
  float* prof = nr + 2 * PL;      // CPML profiles (edge kernels)

#if OVERLAP
  // the next section's kernel reads no output of this one: it may start
  // on the SMs this kernel's last blocks leave free
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
#endif
  const int tid = threadIdx.x;
  const int hl = tid - BZ * BY;  // a halo column's lane, or < 0
  const int wy = hl < 0 ? tid / BZ : hl % BY;
  const int wz = hl < 0 ? tid % BZ + 1 : (hl < BY ? 0 : BZ + 1);
  const int at = wy * RW + wz;
  const int* it = p.plan + PLAN_COLS * (first + static_cast<int>(blockIdx.x));
  const int j0 = it[0], k0 = it[1], ny = it[2], nz = it[3];
  const int x0 = it[4], x1 = it[5];
  const bool grid = it[7] != 0;
  const int n1 = p.g.n[0], n2 = p.g.n[1], n3 = p.g.n[2];
  Col col;
  col.j = j0 - 1 + wy;
  col.k = k0 - 1 + wz;
  const int j = col.j, k = col.k;
  const bool inside =
      wy < ny + 2 && wz < nz + 2 && j >= 0 && j < n2 && k >= 0 && k < n3;
  const bool halo_e = inside && wy >= 1 && wz >= 1;  // the new E is read
  const bool own = halo_e && wy <= ny && wz <= nz;   // owns its cells
  const int cidx = inside ? j * n3 + k : 0;
  const int64_t pstride = static_cast<int64_t>(n2) * n3;
  col.qy = (AX & 2) ? slab_plane(j, n2, p.g.m[1]) : -1;
  col.qz = (AX & 4) ? slab_plane(k, n3, p.g.m[2]) : -1;
  const bool y_wall = j == 0 || j == n2 - 1, z_wall = k == 0 || k == n3 - 1;
  col.wall = (y_wall || z_wall ? 1u : 0u) | (z_wall ? 2u : 0u) |
             (y_wall ? 4u : 0u);
  col.ym = j > 0;
  col.zm = k > 0;
  col.yp = j < n2 - 1;
  col.zp = k < n3 - 1;
  const bool pcol = SRC && j == p.pj && k == p.pk;
  // planes of old fields read: < lim (E and H up to x1, the halo plane)
  const int lim = min(n1, x1 + 1);

  if (SRC) {
    copy_table(p.rec[0], p.n_rec[0], tid, tab[0]);
    copy_table(p.rec[1], p.n_rec[1], tid, tab[1]);
  }
  if (AX != 0) {
    for (int f = 0; f < 2; ++f) {
      for (int a = 0; a < 3; ++a) {
        const float* src = (f == 0 ? p.e : p.h).prof[a];
        float* dst = prof + prof_offset(p, f, a);
        for (int t = tid; t < 6 * p.g.m[a]; t += NT) dst[t] = src[t];
      }
    }
  }
  __syncthreads();
  const unsigned cb_e = SRC ? column_bits(tab[0], p.n_rec[0], j, k) : 0u;
  const unsigned cb_h = SRC ? column_bits(tab[1], p.n_rec[1], j, k) : 0u;

  // old H of plane x for the window, and (e) old E for the columns that
  // compute E (thread-private slots: a thread reads only what it
  // loaded, and has used a slot's plane before it refills the slot); one
  // commit group a plane. float: by cp.async into the rings; bf16: into
  // the registers hw, ew, which put_plane widens into the rings
  T hw[3], ew[3];
  auto load_plane = [&](int x, bool e) {
    if (x >= lim || !inside) return;
    const int64_t off = x * pstride + cidx;
    if constexpr (BF) {
#pragma unroll
      for (int c = 0; c < 3; ++c) hw[c] = fld<T>(p.h.F, c)[off];
      if (e && halo_e) {
#pragma unroll
        for (int c = 0; c < 3; ++c) ew[c] = fld<T>(p.e.F, c)[off];
      }
    } else {
      const int s = (x & (RING - 1)) * PL + at;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        cp_async4(hr + s + c * RP, fld<float>(p.h.F, c) + off);
      }
      if (e && halo_e) {
        const int se = (x % ERING) * PL + at;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          cp_async4(er + se + c * RP, fld<float>(p.e.F, c) + off);
        }
      }
    }
  };
  // bf16: the words load_plane(x, e) fetched, widened into the rings
  auto put_plane = [&](int x, bool e) {
    if (!BF || x >= lim || !inside) return;
    const int s = (x & (RING - 1)) * PL + at;
#pragma unroll
    for (int c = 0; c < 3; ++c) hr[s + c * RP] = widen(hw[c]);
    if (e && halo_e) {
      const int se = (x % ERING) * PL + at;
#pragma unroll
      for (int c = 0; c < 3; ++c) er[se + c * RP] = widen(ew[c]);
    }
  };
  if (x0 > 0) {  // H, read by E(x0)
    load_plane(x0 - 1, false);
    put_plane(x0 - 1, false);
  }
#pragma unroll
  for (int q = 0; q < PIPE; ++q) {
    load_plane(x0 + q, true);
    put_plane(x0 + q, true);
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
      const int64_t cell = i * pstride + cidx;
      const bool store = own && i < x1;
      float old[3], out[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) old[c] = er[e_i + c * RP + at];
      const unsigned bits = SRC ? cb_e | plane_bits(tab[0], i) : 0u;
      const unsigned wall = col.wall | (i == 0 || i == n1 - 1 ? 6u : 0u);
      update<true, AX, SRC>(p, &tab[0], prof, bits, pcol && i == p.pi,
                            hr + r_i, hr + r_m, i > 0, at, i,
                            (AX & 1) ? slab_plane(i, n1, p.g.m[0]) : -1, col,
                            wall, grid, cell, old, store, out);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        nr[s_i + c * RP + at] = out[c];
        if (store) st(fld<T>(p.e.out, c) + cell, out[c]);
      }
    }

    // phase H(i-1): the new H on the owned columns, from the new E of
    // plane i-1 (this column and its +y, +z neighbours: written in the
    // iteration before, published by this iteration's barrier) and of
    // plane i (this column only: written just above by this thread), so
    // it needs no barrier of its own
    const int xa = i - 1;
    if (xa >= x0 && own) {
      const int64_t cell = xa * pstride + cidx;
      float old[3], out[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) old[c] = hr[r_m + c * RP + at];
      const unsigned bits = SRC ? cb_h | plane_bits(tab[1], xa) : 0u;
      update<false, AX, SRC>(p, &tab[1], prof, bits, false, nr + s_m,
                             nr + s_i, xa < n1 - 1, at, xa,
                             (AX & 1) ? slab_plane(xa, n1, p.g.m[0]) : -1,
                             col, 0u, grid, cell, old, true, out);
#pragma unroll
      for (int c = 0; c < 3; ++c) st(fld<T>(p.h.out, c) + cell, out[c]);
    }
    // bf16: plane i + PIPE into the rings, after every read of the slots
    // it refills (see load_plane)
    put_plane(i + PIPE, true);
  }
  cp_wait<0>();  // the last groups are empty; none stays in flight
}

template <int AX, bool SRC, int MINB, typename T>
__global__ void __launch_bounds__(NT, MINB)
    fused_section(const Params p, int first) {
  march<AX, SRC, T>(p, first);
}

// Dynamic shared memory of a block: the old H and E rings, the new E
// ring, the CPML profiles.
static int smem_bytes(int msum) {
  return ((RING + ERING + 2) * PL + 12 * msum) *
         static_cast<int>(sizeof(float));
}

typedef void (*Kernel)(const Params, int);

// The plan's sections, in launch order (ops/pallas_fused.py::SECTIONS):
// the slab items of several axes, of x, of y, of z alone, the source
// items, the plain ones; the float build, then the bf16 one.
#define SECTION_KERNELS(T)                                                 \
  {                                                                        \
    fused_section<7, true, EDGE_BLOCKS, T>,                                \
        fused_section<1, true, EDGE_BLOCKS, T>,                            \
        fused_section<2, true, EDGE_BLOCKS, T>,                            \
        fused_section<4, true, EDGE_BLOCKS, T>,                            \
        fused_section<0, true, INNER_BLOCKS, T>,                           \
        fused_section<0, false, INNER_BLOCKS, T>                           \
  }
static const Kernel kKernels[2][SECTIONS] = {SECTION_KERNELS(float),
                                             SECTION_KERNELS(bf16_t)};

static int g_smem_most = 0;  // shared memory a block may have (opt-in)

// Lets every kernel take the largest shared memory a call may need and
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
  for (int q = 0; q < 2 * SECTIONS; ++q) {
    const Kernel k = kKernels[q / SECTIONS][q % SECTIONS];
    cudaFuncAttributes a;
    err = cudaFuncGetAttributes(&a, k);
    if (err != cudaSuccess) return err;
    const int room = most - static_cast<int>(a.sharedSizeBytes);
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               want < room ? want : room);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(k,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    }
    if (err != cudaSuccess) return err;
  }
  done = true;
  return cudaSuccess;
}

extern "C" {

int fdtd_params_size() { return static_cast<int>(sizeof(Params)); }

// The geometry the plan must follow: out = {owned y extent of a tile,
// owned z extent (also the alignment of the z cuts)}.
int fdtd_fused_tile(int* out) {
  out[0] = BY - 2;
  out[1] = BZ;
  return 0;
}

// Per section kernel (the float builds, then the bf16 ones), four ints:
// registers a thread, local (spill) bytes a thread, resident blocks an SM
// at the shared memory of CPML of 10 planes on every axis, static shared
// bytes.
int fdtd_fused_occupancy(int* out) {
  cudaError_t err = set_attributes();
  for (int q = 0; q < 2 * SECTIONS && err == cudaSuccess; ++q) {
    const Kernel k = kKernels[q / SECTIONS][q % SECTIONS];
    cudaFuncAttributes a;
    err = cudaFuncGetAttributes(&a, k);
    int blocks = 0;
    const int smem = smem_bytes(30);
    if (err == cudaSuccess &&
        smem + static_cast<int>(a.sharedSizeBytes) <= g_smem_most) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, NT,
                                                          smem);
    }
    out[4 * q] = a.numRegs;
    out[4 * q + 1] = static_cast<int>(a.localSizeBytes);
    out[4 * q + 2] = blocks;
    out[4 * q + 3] = static_cast<int>(a.sharedSizeBytes);
  }
  return static_cast<int>(err);
}

int fdtd_fused_pass(const Params* p, void* stream) {
  cudaError_t err = set_attributes();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int msum = p->g.m[0] + p->g.m[1] + p->g.m[2];
  if (msum > MAX_SLAB_SUM || p->n_rec[0] > MAX_REC ||
      p->n_rec[1] > MAX_REC) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int first = 0;
  for (int q = 0; q < SECTIONS; ++q) {  // in the plan's order
    const int n = p->n_item[q];
    if (n < 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    if (n > 0) {
      int at = first;
      void* args[] = {const_cast<Params*>(p), &at};
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(n);
      cfg.blockDim = dim3(NT);
      cfg.dynamicSmemBytes = smem_bytes(msum);
      cfg.stream = s;
      // a section's kernel may overlap the one before (programmatic
      // dependent launch): they write disjoint cells and read only what
      // the work before the call's first kernel wrote; that first kernel
      // waits for all earlier work on the stream, as every later launch
      // on it waits for the call
      cudaLaunchAttribute attr;
      attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
      attr.val.programmaticStreamSerializationAllowed = 1;
      cfg.attrs = &attr;
      cfg.numAttrs = OVERLAP && first > 0 ? 1 : 0;
      err = cudaLaunchKernelExC(
          &cfg,
          reinterpret_cast<const void*>(kKernels[p->g.bf16 ? 1 : 0][q]),
          args);
      if (err == cudaSuccess) err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    first += n;
  }
  return static_cast<int>(cudaSuccess);
}

const char* fdtd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
