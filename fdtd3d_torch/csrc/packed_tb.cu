// Temporal-blocked packed pass of the 3D Yee scheme at depth k = 2, for
// Hopper (sm_90a): one launch advances E and H by two leapfrog steps.
//
// Replaces the Pallas TPU kernel
// fdtd3d_tpu/ops/pallas_packed_tb.py::make_packed_tb_step (builder :520,
// kernel body :900, pallas_call :1320) for unsharded 3D float32 runs at
// k = 2.
//
// What one launch computes, on the stacked layout E, H = (3, n1, n2, n3)
// float32, C order, z innermost, out of place (source buffers *0,
// destination buffers *2), for generations g = 1, 2:
//   E(g) = ca E(g-1) + cb (curl_b H(g-1) + CPML terms + records(g)
//                          - J(g) + drive(g) at the point source)
//   J(g) = kj J(g-1) + bj E(g-1)
//   H(g) = da H(g-1) - db (curl_f E(g) + CPML terms + records(g))
// with PEC zero ghosts outside the domain, the slab CPML psi recursions
// of every axis on compact slab stacks (as packed_eh.cu), per-cell or
// scalar coefficients, electric Drude J and PEC walls on tangential E.
// The sources are added into the accumulator before the coefficient
// multiply at every generation, as the reference's tb kernel adds them:
// each TFSF record's plane term comes from `terms` (2, total), one row
// per generation, through the record table (component, normal axis,
// plane, offset); the point source adds drive[g-1].
//
// Design. Generation 1 never reaches device memory. One thread block
// owns a (y, z) tile of (BY - 4) x (BZ - 4) cells over one segment of
// the x axis, and marches along x (from one plane before its segment to
// one after, for generation 1's halo); the segments give the card about
// four waves of blocks, so slow blocks (slabs, source planes) spread;
// one thread per (y, z) column of the tile plus a 2-cell halo on each
// side. At iteration i it loads plane i of H(0) (and E(0), prefetched
// one iteration ahead) and computes, in four phases separated by
// barriers: E1(i), H1(i-1), E2(i-1), H2(i-2) (the reference's phase
// lags). E reads H at x-1 and H reads E at x+1, so depth-2 plane rings
// in shared memory for H0, E1, H1 and E2 suffice (8 planes x 3
// components x 512 columns x 4 B = 48 KB). Each phase runs on a region
// that shrinks by one halo cell on the side its stencil reads:
// E1 on [1, B), H1 on [1, B-1), E2 on [2, B-1), H2 on [2, B-2) = the
// owned tile, so halo cells are computed redundantly for generation 1
// (and E2 one cell beyond the tile, for H2's forward differences), with
// their own sources, psi and walls: every decision is taken on global
// coordinates. The thread that owns a column keeps that column's
// generation-1 psi and J in registers, as a one-plane ring. Generation
// 0's fields, psi and J are loaded one plane ahead, so their latency
// hides behind the phases of the current plane. Each column keeps
// bitmasks of the source records that can touch it (the table itself is
// copied once into shared memory), so a cell tests the few x-normal
// records and nothing else. A cell that no slab and no record touches
// (most of the volume) takes a straight-line path with the CPML and
// record code compiled out; the data-dependent branches of the full
// path cost instruction-level parallelism even where they do nothing.
//
// Lanes (the reference's batch=B build of make_packed_tb_step, vmapped
// over a lane-major grid dimension): one launch advances `lanes`
// same-shape scenarios by two steps. The lane rides the grid's z
// dimension beside the x segment (lane = blockIdx.z / segments; the
// segment count is the solo launch's, so every lane runs exactly the
// blocks a solo launch would), and every base pointer steps by a 64-bit
// lane stride: fields and J by 3 n1 n2 n3, psi by its slab extent, a
// coefficient grid by its own stride (0 when shared), the record terms
// by one row of `total` per lane and generation, the point source's
// drive by two values per lane. The record table and its column masks
// depend on geometry only and serve every lane. A solo run is lanes = 1.
//
// In place would be wrong: a block reads halo columns of E, H, psi and J
// that a neighbouring block writes, so the launch reads only the source
// buffers and writes only the destination ones (the caller ping-pongs).
//
// What bounds it on the card: memory bytes. A launch must read E and H
// once and write them once (12 volumes, 48 B/cell for two steps, 24
// B/cell a step, against the two-launch twin's 72) plus the psi slabs;
// the halo columns are re-read, 512 / 336 = 1.52x on the source fields
// at the chosen tile (mostly from L2, where neighbouring blocks read the
// same planes at about the same time). About 120 flops a cell for the
// two steps, far below the card's ~20 flops per byte.
//
// Offsets are 64-bit. Every entry returns cudaGetLastError() so the
// caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_REC 16  // mirrors fdtd3d_torch/ops/packed_tb.py
#define BZ 32       // block extent along z (threadIdx.x), halo included
#define BY 16       // block extent along y (threadIdx.y), halo included
#define HALO 2
#define MIN_SEGMENT 32  // least x planes a block marches over
#define NT (BZ * BY)
#define PLANE (3 * NT)  // floats of one ring plane (three components)

struct Coef {
  const float* grid;  // (n1, n2, n3), (lanes, n1, n2, n3) or nullptr
  long long lane;     // lane stride of grid: 0 (shared) or n1 n2 n3
  float val;          // used when grid is nullptr
};

struct Rec {
  long long off;  // offset of the plane term in a row of `terms`
  int comp;       // component index within the family
  int axis;       // normal axis of the plane
  int plane;      // index of the plane along `axis`
  int pad;
};

struct Family {
  Coef a[3];             // ca (E) / da (H)
  Coef b[3];             // cb (E) / db (H)
  const float* prof[3];  // per axis a: (3, 2 m[a]) rows b, c, 1/kappa
  Rec rec[MAX_REC];
  int n_rec;
};

struct Params {
  const float* E0;        // stacked (lanes, 3, n1, n2, n3), read only
  const float* H0;
  const float* J0;        // Drude J or nullptr
  float* E2;              // destination stacks, written only
  float* H2;
  float* J2;
  const float* psE0[3];   // per axis a: (lanes, 2, n with dim a = 2 m[a])
  const float* psH0[3];   // or null
  float* psE2[3];
  float* psH2[3];
  const float* terms;     // (2, lanes, total) record plane terms
  long long total;
  long long field_lane;   // lane stride of E, H and J: 3 n1 n2 n3
  long long psi_lane[3];  // lane stride of the psi stacks of axis a
  const float* lane_drive;  // (lanes, 2): the drive of a launch of several
                            // lanes (a one-lane launch takes `drive`)
  Family fe, fh;
  Coef kj[3];             // Drude
  Coef bj[3];
  int m[3];               // slab planes per side, 0 = no CPML on the axis
  int pc, pi, pj, pk;     // point source: E component (-1: none), cell
  float drive[2];         // one lane: amplitude * waveform per generation
  int n1, n2, n3;
  int lanes;              // scenarios advanced by one launch
  float inv_dx;
};

// CURL_TERMS of fdtd3d_tpu/layout.py: component c couples
// (derivative axis, source component, sign) = ((c+1)%3, (c+2)%3, +1)
// and ((c+2)%3, (c+1)%3, -1).
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

// Plane of index ia inside the compact 2m-plane slab stack, or -1.
__device__ __forceinline__ int slab_plane(int ia, int n, int m) {
  return ia < m ? ia : (ia >= n - m ? ia - (n - 2 * m) : -1);
}

// Offset of cell (i, j, k) in the psi stack of axis a, row `row`, at
// slab plane q.
__device__ __forceinline__ int64_t psi_offset(int a, int row, int q, int i,
                                              int j, int k, int64_t n1,
                                              int64_t n2, int64_t n3,
                                              int64_t m2) {
  if (a == 0) return ((row * m2 + q) * n2 + j) * n3 + k;
  if (a == 1) return ((row * n1 + i) * m2 + q) * n3 + k;
  return ((row * n1 + i) * n2 + j) * m2 + q;
}

// Index of cell (i, j, k) inside the plane term of a record whose
// normal is `axis` (C order over the two other axes).
__device__ __forceinline__ int64_t plane_index(int axis, int i, int j,
                                               int k, int64_t n2,
                                               int64_t n3) {
  if (axis == 0) return j * n3 + k;
  if (axis == 1) return i * n3 + k;
  return i * n2 + j;
}

// One family's record table in shared memory: the kernel copies it from
// the parameter block once, because indexing the parameter block with a
// runtime index is slow.
struct RecTable {
  int comp[MAX_REC];
  int axis[MAX_REC];
  int plane[MAX_REC];
  long long off[MAX_REC];
};

// The records of a family that can touch this thread's column: per
// component, the bits of the y- and z-normal records whose plane holds
// the column, and, family-wide, the bits of the x-normal records, whose
// plane is checked per cell. Bits in table order.
struct RecMask {
  unsigned col[3];
  unsigned x;
};

__device__ __forceinline__ void copy_table(const Family& f, int r,
                                           RecTable& rt) {
  rt.comp[r] = f.rec[r].comp;
  rt.axis[r] = f.rec[r].axis;
  rt.plane[r] = f.rec[r].plane;
  rt.off[r] = f.rec[r].off;
}

__device__ __forceinline__ RecMask column_mask(const RecTable& rt, int n_rec,
                                               int j, int k) {
  RecMask rm = {{0u, 0u, 0u}, 0u};
  for (int r = 0; r < n_rec; ++r) {
    const unsigned bit = 1u << r;
    const int a = rt.axis[r];
    if (a == 0) {
      rm.x |= bit;
    } else if ((a == 1 ? j : k) == rt.plane[r]) {
      const int c = rt.comp[r];
      rm.col[0] |= c == 0 ? bit : 0u;
      rm.col[1] |= c == 1 ? bit : 0u;
      rm.col[2] |= c == 2 ? bit : 0u;
    }
  }
  return rm;
}

// acc plus the record terms of component c at cell (x, j, k), in table
// order, from the row of generation g and this lane in `terms` (a
// single-lane launch reads row g, as it did before lanes existed).
template <bool MULTI>
__device__ __forceinline__ float add_records(const Params& p,
                                             const RecTable& rt,
                                             const RecMask& rm, int c, int g,
                                             int lane, int x, int j, int k,
                                             float acc) {
  unsigned m = rm.col[c];
  for (unsigned z = rm.x; z; z &= z - 1) {
    const int r = __ffs(z) - 1;
    if (rt.comp[r] == c && rt.plane[r] == x) m |= 1u << r;
  }
  for (; m; m &= m - 1) {
    const int r = __ffs(m) - 1;
    const int64_t row = MULTI ? (int64_t)(g * p.lanes + lane) * p.total
                              : (int64_t)g * p.total;
    acc += p.terms[row + rt.off[r] +
                   plane_index(rt.axis[r], x, j, k, p.n2, p.n3)];
  }
  return acc;
}

// Whether plane x of a family needs the full path: it lies in the x
// slab, or an x-normal record of the family sits on it.
__device__ __forceinline__ bool plane_full(const Params& p,
                                           const RecTable& rt,
                                           const RecMask& rm, int x) {
  bool full = p.m[0] > 0 && slab_plane(x, p.n1, p.m[0]) >= 0;
  for (unsigned z = rm.x; z; z &= z - 1) full |= rt.plane[__ffs(z) - 1] == x;
  return full;
}

// psi of generation 0 at cell (x, j, k) of this lane from the stacks
// `ps`, for every curl term (2 c + t) whose axis has a CPML slab holding
// the cell; the other entries of `out` are left as they are.
__device__ __forceinline__ void load_psi(const Params& p,
                                         const float* const (&ps)[3],
                                         int lane, int x, int j, int k,
                                         float (&out)[6]) {
  const int idx[3] = {x, j, k};
  const int n[3] = {p.n1, p.n2, p.n3};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int a = term_axis(c, t);
      const int m = p.m[a];
      if (m > 0) {
        const int q = slab_plane(idx[a], n[a], m);
        if (q >= 0) {
          out[2 * c + t] = ps[a][lane * p.psi_lane[a] +
                                 psi_offset(a, c < a ? c : c - 1, q, x, j,
                                            k, p.n1, p.n2, p.n3, 2 * m)];
        }
      }
    }
  }
}

// One E cell of generation G + 1 at this thread's column.
// hr: the ring of the H generation G (plane x at offset s0, x-1 at s1);
// old: E(G) of the cell; drive: this lane's point-source values (a
// one-lane launch reads p.drive, a kernel parameter, instead). G = 0
// takes generation 0's psi and J from psi0/j0 (loaded a plane ahead)
// and leaves generation 1's in pe/jr;
// G = 1 takes them from pe/jr and, when `store`, writes generation 2's
// to device memory. FULL = false compiles the CPML and the records out:
// the straight-line path of a cell that no slab and no record touches.
template <int G, bool FULL, bool MULTI>
__device__ __forceinline__ void e_cell(const Params& p, const RecTable& rt,
                                       const RecMask& rm, const float* hr,
                                       int s0, int s1, const int idx[3],
                                       int lane, int64_t cell, int tid,
                                       const float (&old)[3],
                                       const float (&drive)[2],
                                       const float (&psi0)[6],
                                       const float (&j0)[3], float (&pe)[6],
                                       float (&jr)[3], float (&out)[3],
                                       bool store) {
  const int n[3] = {p.n1, p.n2, p.n3};
  const int64_t vol = (int64_t)p.n1 * p.n2 * p.n3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int a = term_axis(c, t);
      const int d = term_comp(c, t);
      const float s = t == 0 ? 1.f : -1.f;
      const float* here = hr + s0 + d * NT + tid;
      float prev;
      if (a == 0) {
        prev = idx[0] > 0 ? hr[s1 + d * NT + tid] : 0.f;
      } else if (a == 1) {
        prev = idx[1] > 0 ? here[-BZ] : 0.f;
      } else {
        prev = idx[2] > 0 ? here[-1] : 0.f;
      }
      const float dfa = (here[0] - prev) * p.inv_dx;
      const int m = p.m[a];
      if (FULL && m > 0) {
        const int q = slab_plane(idx[a], n[a], m);
        if (q >= 0) {
          const float* pr = p.fe.prof[a];
          const float ps_old = G == 0 ? psi0[2 * c + t] : pe[2 * c + t];
          const float psi = pr[q] * ps_old + pr[2 * m + q] * dfa;
          if (G == 0) {
            pe[2 * c + t] = psi;
          } else if (store) {
            p.psE2[a][lane * p.psi_lane[a] +
                      psi_offset(a, c < a ? c : c - 1, q, idx[0], idx[1],
                                 idx[2], p.n1, p.n2, p.n3, 2 * m)] = psi;
          }
          acc += s * ((pr[4 * m + q] - 1.f) * dfa + psi);
        }
      }
      acc += s * dfa;
    }
    if (FULL) {
      acc = add_records<MULTI>(p, rt, rm, c, G, lane, idx[0], idx[1],
                               idx[2], acc);
    }
    if (p.J0) {
      const float jo = G == 0 ? j0[c] : jr[c];
      const float jn = coef(p.kj[c], lane, cell) * jo +
                       coef(p.bj[c], lane, cell) * old[c];
      if (G == 0) {
        jr[c] = jn;
      } else if (store) {
        p.J2[(int64_t)lane * p.field_lane + c * vol + cell] = jn;
      }
      acc -= jn;
    }
    if (c == p.pc && idx[0] == p.pi && idx[1] == p.pj && idx[2] == p.pk) {
      acc += MULTI ? drive[G] : p.drive[G];
    }
    float v = coef(p.fe.a[c], lane, cell) * old[c] +
              coef(p.fe.b[c], lane, cell) * acc;
    // PEC walls: tangential E vanishes on the walls of the two axes
    // other than its own.
#pragma unroll
    for (int w = 0; w < 3; ++w) {
      if (w != c && (idx[w] == 0 || idx[w] == n[w] - 1)) v = 0.f;
    }
    out[c] = v;
  }
}

// One H cell of generation G + 1 at this thread's column.
// er: the ring of the E generation G + 1 (plane x at offset s0, x+1 at
// s1); old: H(G) of the cell; psi and FULL as in e_cell, in psi0/ph.
template <int G, bool FULL, bool MULTI>
__device__ __forceinline__ void h_cell(const Params& p, const RecTable& rt,
                                       const RecMask& rm, const float* er,
                                       int s0, int s1, const int idx[3],
                                       int lane, int64_t cell, int tid,
                                       const float (&old)[3],
                                       const float (&psi0)[6],
                                       float (&ph)[6], float (&out)[3],
                                       bool store) {
  const int n[3] = {p.n1, p.n2, p.n3};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int a = term_axis(c, t);
      const int d = term_comp(c, t);
      const float s = t == 0 ? 1.f : -1.f;
      const float* here = er + s0 + d * NT + tid;
      float next;
      if (a == 0) {
        next = idx[0] < n[0] - 1 ? er[s1 + d * NT + tid] : 0.f;
      } else if (a == 1) {
        next = idx[1] < n[1] - 1 ? here[BZ] : 0.f;
      } else {
        next = idx[2] < n[2] - 1 ? here[1] : 0.f;
      }
      const float dfa = (next - here[0]) * p.inv_dx;
      const int m = p.m[a];
      if (FULL && m > 0) {
        const int q = slab_plane(idx[a], n[a], m);
        if (q >= 0) {
          const float* pr = p.fh.prof[a];
          const float ps_old = G == 0 ? psi0[2 * c + t] : ph[2 * c + t];
          const float psi = pr[q] * ps_old + pr[2 * m + q] * dfa;
          if (G == 0) {
            ph[2 * c + t] = psi;
          } else if (store) {
            p.psH2[a][lane * p.psi_lane[a] +
                      psi_offset(a, c < a ? c : c - 1, q, idx[0], idx[1],
                                 idx[2], p.n1, p.n2, p.n3, 2 * m)] = psi;
          }
          acc += s * ((pr[4 * m + q] - 1.f) * dfa + psi);
        }
      }
      acc += s * dfa;
    }
    if (FULL) {
      acc = add_records<MULTI>(p, rt, rm, c, G, lane, idx[0], idx[1],
                               idx[2], acc);
    }
    out[c] = coef(p.fh.a[c], lane, cell) * old[c] -
             coef(p.fh.b[c], lane, cell) * acc;
  }
}

// MULTI = false is the launch of a single lane (a solo run, or a batch
// of one): the lane is the constant 0, every lane offset folds away and
// the drive is a kernel parameter, so the solo pass compiles to the code
// it had before lanes existed.
template <bool MULTI>
__global__ void __launch_bounds__(NT, 1) tb_pass(const Params p) {
  extern __shared__ float ring[];
  float* h0r = ring;              // H(t)   planes i, i-1
  float* e1r = ring + 2 * PLANE;  // E(t+1) planes i, i-1
  float* h1r = ring + 4 * PLANE;  // H(t+1) planes i-1, i-2
  float* e2r = ring + 6 * PLANE;  // E(t+2) planes i-1, i-2
  __shared__ RecTable rt_e, rt_h;

  const int lz = threadIdx.x, ly = threadIdx.y;
  const int tid = ly * BZ + lz;
  const int k = blockIdx.x * (BZ - 2 * HALO) - HALO + lz;
  const int j = blockIdx.y * (BY - 2 * HALO) - HALO + ly;
  const int n1 = p.n1;
  // this block's lane and x segment [x0, x1): it marches from x0 - 1
  // (generation 1's halo plane) to x1 + 1, and writes generation 2 on
  // [x0, x1) only
  // (a single-lane launch keeps the solo pass's own unsigned arithmetic)
  const unsigned segs = MULTI ? gridDim.z / p.lanes : gridDim.z;
  const int lane = MULTI ? blockIdx.z / segs : 0;
  const int xs = (n1 + segs - 1) / segs;
  const int x0 = (MULTI ? blockIdx.z % segs : blockIdx.z) * xs;
  if (x0 >= n1) return;  // the whole block: before any barrier
  const int x1 = min(x0 + xs, n1);
  const int lim = min(n1, x1 + 2);  // planes of generation 0 read: < lim
  const int ib = max(x0 - 1, 0);    // the first iteration
  const int64_t vol = (int64_t)n1 * p.n2 * p.n3;
  const int64_t pstride = (int64_t)p.n2 * p.n3;
  const bool inside = j >= 0 && j < p.n2 && k >= 0 && k < p.n3;
  // the shrinking regions of the four phases (see the header)
  const bool in_e1 = inside && ly >= 1 && lz >= 1;
  const bool in_h1 = in_e1 && ly < BY - 1 && lz < BZ - 1;
  const bool in_e2 = in_h1 && ly >= 2 && lz >= 2;
  const bool own = in_e2 && ly < BY - 2 && lz < BZ - 2;
  const int64_t col = inside ? (int64_t)j * p.n3 + k : 0;
  // the lane's offset in the field and J stacks (psi and coefficient
  // grids take theirs where they are read); 0 in a single-lane launch
  const int64_t lf = lane * p.field_lane;
  // a launch of several lanes reads its lane's point-source values once:
  // a register operand lets every cell add them branch-free, as the
  // kernel parameter of a one-lane launch does
  float drive[2] = {0.f, 0.f};
  if (MULTI && p.pc >= 0) {
    drive[0] = p.lane_drive[2 * lane];
    drive[1] = p.lane_drive[2 * lane + 1];
  }

  if (tid < p.fe.n_rec) copy_table(p.fe, tid, rt_e);
  if (tid < p.fh.n_rec) copy_table(p.fh, tid, rt_h);
  __syncthreads();
  const RecMask rm_e = column_mask(rt_e, p.fe.n_rec, j, k);
  const RecMask rm_h = column_mask(rt_h, p.fh.n_rec, j, k);
  // columns that a y or z slab or a y- or z-normal record touches take
  // the full path on every plane; the others only on full planes
  const bool col_slab = (p.m[1] > 0 && slab_plane(j, p.n2, p.m[1]) >= 0) ||
                        (p.m[2] > 0 && slab_plane(k, p.n3, p.m[2]) >= 0);
  const bool col_e = col_slab || (rm_e.col[0] | rm_e.col[1] | rm_e.col[2]);
  const bool col_h = col_slab || (rm_h.col[0] | rm_h.col[1] | rm_h.col[2]);

  // generation-1 recursion state of this column: the plane just made
  // (*_new) and the one before (*_old)
  float pe_new[6] = {0.f}, pe_old[6] = {0.f};
  float ph_new[6] = {0.f}, ph_old[6] = {0.f};
  float j_new[3] = {0.f}, j_old[3] = {0.f};

  // generation-0 operands loaded one plane ahead: H and E of plane i + 1
  // at the top of iteration i; psi_E and J of plane i + 1 after E1(i);
  // psi_H of plane i after H1(i - 1)
  float hn[3] = {0.f, 0.f, 0.f}, en[3] = {0.f, 0.f, 0.f};
  float jn[3] = {0.f, 0.f, 0.f};
  float pse[6] = {0.f}, psh[6] = {0.f};
  const int64_t first = (int64_t)ib * pstride + col;
  if (inside) {
    if (ib > 0) {  // H of plane ib - 1, read by E1(ib)
      const int64_t before = first - pstride;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        h0r[((ib - 1) & 1) * PLANE + c * NT + tid] =
            p.H0[lf + c * vol + before];
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      hn[c] = p.H0[lf + c * vol + first];
      en[c] = p.E0[lf + c * vol + first];
    }
  }
  if (in_e1) {
    load_psi(p, p.psE0, lane, ib, j, k, pse);
    if (p.J0) {
#pragma unroll
      for (int c = 0; c < 3; ++c) jn[c] = p.J0[lf + c * vol + first];
    }
  }
  if (in_h1) load_psi(p, p.psH0, lane, ib, j, k, psh);

  for (int i = ib; i <= x1 + 1; ++i) {
    // ring offsets: plane i (and i-2) in slot i & 1, plane i-1 in the other
    const int s_i = (i & 1) * PLANE;
    const int s_m = ((i + 1) & 1) * PLANE;
    float e_old[3];
    if (i < lim) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        h0r[s_i + c * NT + tid] = hn[c];
        e_old[c] = en[c];
      }
      if (inside && i + 1 < lim) {
        const int64_t nxt = (int64_t)(i + 1) * pstride + col;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          hn[c] = p.H0[lf + c * vol + nxt];
          en[c] = p.E0[lf + c * vol + nxt];
        }
      }
    }
    __syncthreads();

    // phase E1(i)
    if (i < lim && in_e1) {
      const int idx[3] = {i, j, k};
      float out[3];
      if (col_e || plane_full(p, rt_e, rm_e, i)) {
        e_cell<0, true, MULTI>(p, rt_e, rm_e, h0r, s_i, s_m, idx, lane,
                               (int64_t)i * pstride + col, tid, e_old, drive,
                               pse, jn, pe_new, j_new, out, false);
      } else {
        e_cell<0, false, MULTI>(p, rt_e, rm_e, h0r, s_i, s_m, idx, lane,
                                (int64_t)i * pstride + col, tid, e_old, drive,
                                pse, jn, pe_new, j_new, out, false);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) e1r[s_i + c * NT + tid] = out[c];
      if (i + 1 < lim) {
        load_psi(p, p.psE0, lane, i + 1, j, k, pse);
        if (p.J0) {
          const int64_t nxt = (int64_t)(i + 1) * pstride + col;
#pragma unroll
          for (int c = 0; c < 3; ++c) jn[c] = p.J0[lf + c * vol + nxt];
        }
      }
    }
    __syncthreads();

    // phase H1(i-1): E1 at i-1 and i, H0 at i-1
    const int xa = i - 1;
    if (xa >= ib && xa <= x1 && xa < n1 && in_h1) {
      const int idx[3] = {xa, j, k};
      float old[3], out[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) old[c] = h0r[s_m + c * NT + tid];
      if (col_h || plane_full(p, rt_h, rm_h, xa)) {
        h_cell<0, true, MULTI>(p, rt_h, rm_h, e1r, s_m, s_i, idx, lane,
                               (int64_t)xa * pstride + col, tid, old, psh,
                               ph_new, out, false);
      } else {
        h_cell<0, false, MULTI>(p, rt_h, rm_h, e1r, s_m, s_i, idx, lane,
                                (int64_t)xa * pstride + col, tid, old, psh,
                                ph_new, out, false);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) h1r[s_m + c * NT + tid] = out[c];
      if (i <= x1 && i < n1) load_psi(p, p.psH0, lane, i, j, k, psh);
    }
    __syncthreads();

    // phase E2(i-1): H1 at i-1 and i-2, E1 at i-1; written on [x0, x1)
    if (xa >= x0 && xa <= x1 && xa < n1 && in_e2) {
      const int idx[3] = {xa, j, k};
      const int64_t cell = (int64_t)xa * pstride + col;
      const bool store = own && xa < x1;
      float old[3], out[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) old[c] = e1r[s_m + c * NT + tid];
      if (col_e || plane_full(p, rt_e, rm_e, xa)) {
        e_cell<1, true, MULTI>(p, rt_e, rm_e, h1r, s_m, s_i, idx, lane,
                               cell, tid, old, drive, pse, jn, pe_old, j_old,
                               out, store);
      } else {
        e_cell<1, false, MULTI>(p, rt_e, rm_e, h1r, s_m, s_i, idx, lane,
                                cell, tid, old, drive, pse, jn, pe_old,
                                j_old, out, store);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        e2r[s_m + c * NT + tid] = out[c];
        if (store) p.E2[lf + c * vol + cell] = out[c];
      }
    }
    __syncthreads();

    // phase H2(i-2): E2 at i-2 and i-1, H1 at i-2
    const int x2 = i - 2;
    if (x2 >= x0 && x2 < x1 && own) {
      const int idx[3] = {x2, j, k};
      const int64_t cell = (int64_t)x2 * pstride + col;
      float old[3], out[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) old[c] = h1r[s_i + c * NT + tid];
      if (col_h || plane_full(p, rt_h, rm_h, x2)) {
        h_cell<1, true, MULTI>(p, rt_h, rm_h, e2r, s_i, s_m, idx, lane,
                               cell, tid, old, psh, ph_old, out, true);
      } else {
        h_cell<1, false, MULTI>(p, rt_h, rm_h, e2r, s_i, s_m, idx, lane,
                                cell, tid, old, psh, ph_old, out, true);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) p.H2[lf + c * vol + cell] = out[c];
    }

    // the plane made this iteration is the next iteration's old plane
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      pe_old[q] = pe_new[q];
      ph_old[q] = ph_new[q];
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) j_old[c] = j_new[c];
  }
}

// Segments of the x axis: enough blocks for about four waves over the
// card's SMs (one block each), each segment at least MIN_SEGMENT planes
// (a segment recomputes up to three planes of generation 1 beyond its
// ends).
static int segments(int blocks_yz, int n1) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess) {
      sms = 132;  // the H100 SXM's count
    }
  }
  const int want = (4 * sms + blocks_yz - 1) / blocks_yz;
  const int most = n1 / MIN_SEGMENT;
  const int n = want < most ? want : most;
  return n > 1 ? n : 1;
}

extern "C" {

int fdtd_tb_params_size() { return static_cast<int>(sizeof(Params)); }

int fdtd_tb_pass(const Params* p, void* stream) {
  const int smem = 8 * PLANE * static_cast<int>(sizeof(float));
  static bool attr_set = false;
  if (!attr_set) {
    const cudaFuncAttribute attr =
        cudaFuncAttributeMaxDynamicSharedMemorySize;
    cudaError_t err = cudaFuncSetAttribute(tb_pass<false>, attr, smem);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(tb_pass<true>, attr, smem);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const dim3 block(BZ, BY);
  const int gz = (p->n3 + BZ - 2 * HALO - 1) / (BZ - 2 * HALO);
  const int gy = (p->n2 + BY - 2 * HALO - 1) / (BY - 2 * HALO);
  // the solo launch's segments for every lane, the lane beside them
  const int segs = segments(gz * gy, p->n1);
  if (p->lanes < 1 || (long long)segs * p->lanes > 65535) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const dim3 grid(gz, gy, segs * p->lanes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->lanes == 1) {
    tb_pass<false><<<grid, block, smem, s>>>(*p);
  } else {
    tb_pass<true><<<grid, block, smem, s>>>(*p);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* fdtd_tb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
