// Two-pass family update of the 3D Yee scheme, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// fdtd3d_tpu/ops/pallas3d.py::make_family_kernel (builder :167, kernel
// body :293, pallas_call :507) for 3D real float32 and bf16 storage,
// unsharded, together with what the reference's step
// (make_pallas_step :1068) patches onto each launch's output: the x
// slab CPML post-pass (x_slab_post :852), the TFSF face patches
// (tfsf_patch :961) and the point source (point_source_patch :1012).
// The step around it is fdtd3d_torch/ops/pallas3d.py::make_pallas_step.
//
// What one launch computes, on per-component arrays (n1, n2, n3)
// float32 or bf16 (Grid.bf16: fields loaded as floats, computed in
// float32, rounded to bf16 where they are stored; psi, J, K, the record
// terms and the coefficients float32), C order, z innermost (the
// reference's unpacked state), out of place (old arrays read, fresh
// arrays written):
//   E' = ca E + cb (curl_b H + CPML terms + records - J' + drive),
//   J' = kj J + bj E                       (fdtd_e_family)
//   H' = da H - db (curl_f E' + CPML terms + records + K'),
//   K' = km K + bm H                       (fdtd_h_family, from the new E)
// Each curl term is s * dfa, plus, on a CPML slab of its axis (x, y or
// z alike), s * ((ik - 1) dfa + psi') with psi' = b psi + c dfa on the
// compact slab psi (2m planes along the axis). Each TFSF record of the
// family adds its plane term (ops/tfsf.py::record_terms, one vector a
// step for both families) into the accumulator at its plane before the
// coefficient multiply, in table order; the point source adds `drive`
// (ps_amp times the waveform) after the Drude current; the PEC walls
// (tangential E vanishes on the walls of the two axes other than its
// own) come last, so a record on a wall cell stays zero. PEC zero
// ghosts outside the domain; per-cell or scalar coefficients. Nothing
// is patched afterwards. The per-cell arithmetic and the record table
// are csrc/family_cell.cuh (curl_term, new_value, RecTable); the V-cell
// word helpers are csrc/march.cuh, shared with csrc/packed_eh.cu, whose
// march this one follows but cannot share (it updates stacked
// (3, n1, n2, n3) arrays in place, lane by lane; this one per-component
// arrays out of place); this file supplies the march, the differences
// and the sources.
//
// Every operation is the plain version's (pallas3d.e_family_plain,
// h_family_plain), in its order. No cell is computed twice (a block
// computes exactly the cells it owns and only reads the other family's
// halo), so the kernel would be correct with FMA contraction too; the
// library is built with --fmad=false all the same
// (ops/build.py::LIBRARY_FLAGS), so a launch reproduces the plain
// version's bits and is held to them bit for bit on the card.
//
// The march (after csrc/packed_eh.cu). A thread block owns one work
// item of the host's plan (ops/pallas3d.py::plan_items, one plan per
// family): a (y, z) tile of at most TY rows by TZ = 32 V columns (V = 2
// cells a thread where the build takes pairs, else 1), the z cuts at
// multiples of TZ so that every owned row is whole aligned 128-byte
// lines, over an x segment [x0, x1). Warp w owns row j0 + w, lane l the
// V cells k0 + l V ... of it. The block marches x (E upwards, H
// downwards, so that each family's x neighbour is the plane before in
// the march) and at each plane:
// - the other family's plane (H for E, E for H) lands in a shared
//   memory ring of SLOTS planes, brought by cp.async PIPE planes ahead
//   (one word of V cells a thread and component): the tile, a 1-cell
//   halo row (E: the row below, H: the row above; components 0 and 2,
//   by warp 0) and a 1-cell halo column word (E: left of the tile, H:
//   right of it; components 0 and 1, by the last warp). Ring cells
//   outside the domain are zeroed once and never loaded: the PEC
//   ghosts;
// - the y and z neighbours come from the ring, the x neighbour from the
//   two components (1 and 2, the two with an x term) a thread kept in
//   registers from the plane before;
// - the family's old values and J or K come through the thread's own
//   slots of rings of the same depth; psi, the record terms and the
//   coefficient grids are read by the thread that needs them; every
//   output is written once, in V-cell words, by the cell's owner;
// - one barrier a plane: it publishes the plane that landed and
//   retires the slot the next cp.async refills.
//
// Sections. The plan classes an item by the cells it owns: SLAB if one
// lies in a CPML slab of any axis, SOURCE if one lies on a record plane
// of the family or (E) is the point source's cell, PLAIN otherwise
// (pallas3d.item_class). Each class is its own kernel (kKernels): the
// SLAB kernel has the psi path and the sources compiled in (a TFSF face
// inside a CPML slab puts both in one cell), the SOURCE kernel the
// record and point-source code only, the PLAIN kernel neither. Each
// section starts on the SMs the one before leaves free (programmatic
// dependent launch): the sections write disjoint cells and read only the
// launch's inputs. Coefficient grids are read only by the items whose
// cells reach the box outside which every grid of the family holds its
// background value (the plan row's flag; pallas3d.material); the others
// take the background from the Coef's scalar, a uniform branch a block.
//
// bf16 storage: a thread takes two z cells (a bf16x2 word) where n3 is
// even, so every field request is 4 bytes, cp.async copies the words
// into bf16 rings and they are widened where they are read; an odd n3
// takes one cell a thread, its 2-byte words copied by ordinary loads.
// Each new value is rounded once, where it is stored, so the H launch
// reads the rounded E, as the plain version does.
//
// What bounds it on the card: memory bytes. A launch must read the
// other family and its own once and write its own once (9 field
// volumes), plus J or K (read and written), the psi of every slab axis,
// the record terms and the coefficient grids inside their box; ~20
// flops a cell. A step of two launches moves 18 field volumes.
//
// The design for the H100: each choice against its alternative in one
// call of scripts/family_variants.py (ms of e_family + h_family, each
// launched from a prebuilt parameter block, on vacuum3D_tfsf's state at
// 256^3 in f32 / in bf16, on the Mie example at 512^3 (f32, grids in the
// sphere's box) / on the double-negative sphere at 256^3 (f32: J, K and
// their grids); NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6). As
// built: 0.595 / 0.496 / 4.012 / 0.904. The first design of this file,
// one thread a cell with the patches after it, took 0.64 / 0.59 / 5.68
// ms for its two launches (scripts/solo_kernel_times.py, the same kind
// of call).
// 1. Tiles of 4 rows, one warp a row (8 rows, the packed twin's tile:
//    0.608 / 0.506 / 4.061 / 0.941; 16: 0.636 / 0.509 / 4.210 / 0.942;
//    2: 0.592 / 0.493 / 4.029 / 0.916).
// 2. Two cells a thread in float32 too where n3 is even (one: 0.595 /
//    0.496 / 4.242 / 0.908; with 8-row tiles, the first design, 0.611 /
//    0.506 / 4.307 / 0.929). The packed twin's float32 pairs lost (its
//    header); here they pay on the grid-bearing states.
// 3. Registers for eight blocks an SM in float32 (six: 0.621 on the
//    f32 256^3 state, 4.123 on Mie, 0.922 on the sphere) and six in
//    bf16 (four: 0.588; eight: 0.481, E faster and H slower, with
//    64-byte spills in the slab kernels: not taken on one state). The
//    float32 pair kernels spill 12 bytes at eight blocks.
// 4. PIPE = 2 planes ahead (1: 0.602 / 0.489 / 4.074 / 0.908; 3: 0.605
//    / 0.497 / 4.108 / 0.962).
// 5. SLAB, SOURCE and PLAIN sections by their own kernels (every item
//    in the SLAB kernel: 0.608 / 0.552 / 4.162 / 0.917), each started by
//    programmatic dependent launch (without: 0.669 / 0.581 / 4.116 /
//    0.996).
// 6. Grids read only inside their box (every item reading them: 0.595
//    / 0.495 / 5.015 / 1.261).
// 7. x segments of 16 planes (8: 0.587 / 0.492 / 4.041 / 0.902; 32:
//    0.692 / 0.519 / 4.032 / 0.971).
// 8. No FMA contraction (contracted: 0.592 / 0.491 / 4.002 / 0.900, up
//    to 1% faster, but not the plain version's bits).
// Timing-only builds split the time: the loads, barriers and rings
// alone 0.296 / 0.173 / 2.232 / 0.618, with the stores 0.449 / 0.244 /
// 3.454 / 0.763; the arithmetic the rest.
//
// Build knobs (-D): TY (tile rows), PIPE (planes in flight ahead of the
// march), F32_PAIRS (two cells a thread in the float32 build),
// SECTIONS (0: every item in the SLAB kernel), MIN_BLOCKS and
// F32_BLOCKS (resident blocks an SM the register budget is set for:
// the bf16 builds, the float32 builds), OVERLAP (programmatic dependent
// launch of the sections). Timing-only builds are source patches of
// scripts/family_variants.py, not knobs of this file.
//
// Offsets are 64-bit across planes. Every entry returns
// cudaGetLastError() (or the first error) so the caller can raise on a
// refused launch.

#include "family_cell.cuh"
#include "march.cuh"

#ifndef TY
#define TY 4  // rows of a tile, one warp each
#endif
#ifndef PIPE
#define PIPE 2  // planes in flight ahead of the march
#endif
#ifndef F32_PAIRS
#define F32_PAIRS 1  // two z cells a thread in the float32 build too
#endif
#ifndef SECTIONS
#define SECTIONS 1  // SLAB, SOURCE and PLAIN items by their own kernels
#endif
#ifndef MIN_BLOCKS
#define MIN_BLOCKS 6  // resident blocks an SM the registers are set for:
#endif                // bf16 builds
#ifndef F32_BLOCKS
#define F32_BLOCKS 8  // the float32 builds'
#endif
#ifndef OVERLAP
#define OVERLAP 1  // a section's kernel may start while the one before ends
#endif
#define NT (TY * 32)      // threads a block
#define SLOTS (PIPE + 1)  // ring planes
#define PLAN_COLS 8       // j0, k0, ny, nz, x0, x1, class, grid
#define N_SECTIONS 3      // SLAB, SOURCE, PLAIN; mirrors ops/pallas3d.py
#if PIPE < 1 || PIPE > 3
#error "PIPE must lie in [1, 3]"
#endif

struct Params {
  FamOps f;               // the family updated: old values, fresh
                          // outputs, psi of every CPML axis, profiles,
                          // a and b coefficients
  const void* S[3];       // the curl source family (float or bf16)
  Drude dr;               // the family's ADE current: J (E) or K (H);
                          // null pointers without it
  Grid g;
  const float* terms;     // (total,) record terms, or nullptr
  const int* plan;        // (items, PLAN_COLS) work items, by section
  Rec rec[MAX_REC];       // the family's TFSF records, in table order
  int n_rec;
  int pc, pi, pj, pk;     // the point source's component (-1: none), cell
  float drive;            // ps_amp * waveform(t)
  int pairs;              // the plan's tiles take two z cells a thread
  int n_item[N_SECTIONS];  // items of each section, in launch order
};

// A coefficient's V cells: its grid where the item reads grids, else its
// scalar (for an item outside the grids' box, the grid's background).
template <int V>
__device__ __forceinline__ void coef_v(const Coef& c, bool grid,
                                       int64_t cell, float (&out)[V]) {
  if (grid && c.grid) {
    ldv<V>(c.grid + cell, out);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) out[v] = c.val;
  }
}

// Shared memory of a block, for fields of T and V cells a thread: the
// source ring (SLOTS planes of the tile, its halo row and halo column
// word, three components), then the own rings of the same depth (the
// old family, and J or K where the launch has it: the owned cells only,
// each thread's own words).
template <typename T, int V>
struct Ring {
  static constexpr int TZ = 32 * V;         // owned columns of a tile
  static constexpr int RW = TZ + V;         // a source ring row: the
                                            // owned cells and the halo word
  static constexpr int RP = (TY + 1) * RW;  // a source plane, a component
  static constexpr int OP = TY * TZ;        // an own plane, a component
  static constexpr int S_BYTES =
      round16(SLOTS * 3 * RP * static_cast<int>(sizeof(T)));
  static constexpr int F_BYTES =
      round16(SLOTS * 3 * OP * static_cast<int>(sizeof(T)));
  static constexpr int J_BYTES = round16(SLOTS * 3 * OP * 4);
  static int bytes(bool j) { return S_BYTES + F_BYTES + (j ? J_BYTES : 0); }
};

// One work item: the march of one family's update over its x segment.
// BACKWARD = true: E from backward differences of H (Drude J, the point
// source, PEC walls), marching x upwards; false: H from forward
// differences of E (magnetic Drude K), marching downwards. KIND: the
// section (0 SLAB: the psi path and the sources compiled in; 1 SOURCE:
// the sources only; 2 PLAIN: neither). T: the fields' storage type; V:
// z cells a thread.
template <bool BACKWARD, int KIND, typename T, int V>
__global__ void __launch_bounds__(NT, sizeof(T) == 4 ? F32_BLOCKS
                                                     : MIN_BLOCKS)
    family_section(const Params p, int first) {
  constexpr bool SLAB = KIND == 0;
  constexpr bool SRC = KIND != 2;
  typedef Ring<T, V> Rg;
  constexpr int TZ = Rg::TZ, RW = Rg::RW, RP = Rg::RP, OP = Rg::OP;
  constexpr int COL0 = BACKWARD ? V : 0;   // the owned cells' first column
  constexpr int HCOL = BACKWARD ? 0 : TZ;  // the halo word's
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ RecTable tab;
  T* const ring = reinterpret_cast<T*>(smem);
  T* const fr = reinterpret_cast<T*>(smem + Rg::S_BYTES);
  float* const jr = reinterpret_cast<float*>(smem + Rg::S_BYTES +
                                             Rg::F_BYTES);

#if OVERLAP
  // the next section's kernel reads no output of this one: it may start
  // on the SMs this kernel's last blocks leave free
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
#endif
  const int* it = p.plan + PLAN_COLS * (first + static_cast<int>(blockIdx.x));
  const int j0 = it[0], k0 = it[1], ny = it[2], nz = it[3];
  const int x0 = it[4], x1 = it[5];
  const bool grid = it[7] != 0;
  // warp w takes tile row w, its lane l the V cells from column l V on
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int n1 = p.g.n[0], n2 = p.g.n[1], n3 = p.g.n[2];
  const int64_t pstride = static_cast<int64_t>(n2) * n3;
  const bool ade = p.dr.Jin[0] != nullptr;

  // this thread's cells: row j, columns kk .. kk + V - 1
  const int j = j0 + w;
  const int kk = k0 + l * V;
  const bool own = w < ny && l * V < nz;
  const int at = (BACKWARD ? w + 1 : w) * RW + COL0 + l * V;  // in a slot
  const int oat = w * TZ + l * V;  // in an own ring plane
  // the halo row (E: below the tile, H: above it) and column word
  const int hj = BACKWARD ? j0 - 1 : j0 + ny;
  const bool hrow = w == 0 && hj >= 0 && hj < n2 && l * V < nz;
  const int hat = (BACKWARD ? 0 : ny) * RW + COL0 + l * V;
  const int hk = BACKWARD ? k0 - V : k0 + TZ;
  const bool hcol = w == TY - 1 && l < ny &&
                    (BACKWARD ? k0 > 0 : nz == TZ && k0 + TZ < n3);
  const int hcat = (BACKWARD ? l + 1 : l) * RW + HCOL;
  const int64_t own_off = static_cast<int64_t>(j) * n3 + kk;
  const int64_t hrow_off = static_cast<int64_t>(hj) * n3 + kk;
  const int64_t hcol_off = static_cast<int64_t>(j0 + l) * n3 + hk;

  // facts of the thread's columns, fixed over the march
  const int qy = SLAB ? slab_plane(j, n2, p.g.m[1]) : -1;
  const bool y_wall = j == 0 || j == n2 - 1;
  int qz[V];
  bool z_wall[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    qz[v] = SLAB ? slab_plane(kk + v, n3, p.g.m[2]) : -1;
    z_wall[v] = kk + v == 0 || kk + v == n3 - 1;
  }

  // the source family's plane i into ring slot `slot`, and the thread's
  // own old values and J or K of plane i into its own slots
  auto load_plane = [&](int i, int slot) {
    T* rs = ring + slot * 3 * RP;
    const int64_t base = static_cast<int64_t>(i) * pstride;
    if (own) {
      const int64_t cell = base + own_off;
      const int os = slot * 3 * OP + oat;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        copy_word<V>(rs + c * RP + at, fld<T>(p.S, c) + cell);
        copy_word<V>(fr + os + c * OP, fld<T>(p.f.F, c) + cell);
        if (ade) copy_word<V>(jr + os + c * OP, p.dr.Jin[c] + cell);
      }
    }
    if (hrow) {  // components 0 and 2 have the y terms
      copy_word<V>(rs + hat, fld<T>(p.S, 0) + base + hrow_off);
      copy_word<V>(rs + 2 * RP + hat, fld<T>(p.S, 2) + base + hrow_off);
    }
    if (hcol) {  // components 0 and 1 have the z terms
      copy_word<V>(rs + hcat, fld<T>(p.S, 0) + base + hcol_off);
      copy_word<V>(rs + RP + hcat, fld<T>(p.S, 1) + base + hcol_off);
    }
  };

  const int dir = BACKWARD ? 1 : -1;
  const int start = BACKWARD ? x0 : x1 - 1;
  const int count = x1 - x0;
  // the x neighbours of the first plane (E: H(x0 - 1), H: E(x1)) of
  // components 1 and 2, the two with an x term; the PEC ghost outside
  float xn[2][V];
  {
    const int xi = start - dir;
    const bool in = own && xi >= 0 && xi < n1;
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      if (in) {
        ldv<V>(fld<T>(p.S, d + 1) + static_cast<int64_t>(xi) * pstride +
                   own_off,
               xn[d]);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) xn[d][v] = 0.f;
      }
    }
  }
  // every source ring cell a load does not fill stays 0: the PEC ghosts
  for (int t = threadIdx.x; t < Rg::S_BYTES / 4; t += NT) {
    reinterpret_cast<unsigned*>(smem)[t] = 0u;
  }
  if (SRC) copy_table(p.rec, p.n_rec, threadIdx.x, tab);
  __syncthreads();
  // the y- and z-normal records on each of the thread's columns, and
  // whether a column is the point source's
  unsigned cbits[V];
  bool pcol[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    cbits[v] = SRC ? column_bits(tab, p.n_rec, j, kk + v) : 0u;
    pcol[v] = SRC && BACKWARD && j == p.pj && kk + v == p.pk;
  }
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
    const int qx = SLAB ? slab_plane(i, n1, p.g.m[0]) : -1;
    const bool x_wall = i == 0 || i == n1 - 1;
    const unsigned pbits = SRC ? plane_bits(tab, i) : 0u;
    const bool pplane = SRC && BACKWARD && i == p.pi;

#pragma unroll
    for (int c = 0; c < 3; ++c) {
      // the differences of the two curl terms over dx, each cell
      float dfa[2][V];
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
          dfa[t][v] = (BACKWARD ? here[d][v] - nb[v] : nb[v] - here[d][v]) *
                      p.g.inv_dx;
        }
      }
      float ca[V], cb[V], ka[V], kb[V], old[V], jo[V], jn[V], out[V];
      coef_v<V>(p.f.a[c], grid, cell0, ca);
      coef_v<V>(p.f.b[c], grid, cell0, cb);
      ldv<V>(fr + os + c * OP, old);
      if (ade) {
        coef_v<V>(p.dr.kj[c], grid, cell0, ka);
        coef_v<V>(p.dr.bj[c], grid, cell0, kb);
        ldv<V>(jr + os + c * OP, jo);
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int k = kk + v;
        float acc = 0.f;
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int a = term_axis(c, t);
          float term;
          if (SLAB && p.f.psi_in[c][t] != nullptr) {
            const int q = a == 0 ? qx : (a == 1 ? qy : qz[v]);
            const int m2 = 2 * p.g.m[a];
            term = curl_term(t, dfa[t][v], q, p.f.prof[a], m2,
                             p.f.psi_in[c][t], p.f.psi_out[c][t],
                             q >= 0 ? slab_offset(a, q, i, j, k, n2, n3, m2)
                                    : 0);
          } else {
            term = t == 0 ? dfa[t][v] : -dfa[t][v];
          }
          acc = t == 0 ? term : acc + term;
        }
        if (SRC) {  // the family's records on the cell, in table order
          for (unsigned b = (cbits[v] | pbits) & tab.cbits[c]; b;
               b &= b - 1) {
            const int r = __ffs(b) - 1;
            acc = acc + p.terms[tab.off[r] + plane_index(tab.axis[r], i, j,
                                                         k, n2, n3)];
          }
        }
        jn[v] = ade ? ka[v] * jo[v] + kb[v] * old[v] : 0.f;
        // PEC walls: tangential E vanishes on the walls of the two axes
        // other than its own
        const bool wall = BACKWARD && ((c != 0 && x_wall) ||
                                       (c != 1 && y_wall) ||
                                       (c != 2 && z_wall[v]));
        out[v] = new_value<BACKWARD>(old[v], acc, ca[v], cb[v], ade, jn[v],
                                     pplane && pcol[v] && c == p.pc,
                                     p.drive, wall);
      }
      stv<V>(fld<T>(p.f.out, c) + cell0, out);
      if (ade) stv<V>(p.dr.Jout[c] + cell0, jn);
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

// The builds: [family][storage][cells a thread][section]. Storage 0
// float32, 1 bf16; cells a thread 0: one, 1: two (the float32 build's
// two-cell entry is its one-cell kernel unless F32_PAIRS); sections
// SLAB, SOURCE, PLAIN (each the SLAB kernel when SECTIONS is 0).
#if SECTIONS
#define SECTION_KERNELS(B, T, V)                                   \
  {                                                                \
    family_section<B, 0, T, V>, family_section<B, 1, T, V>,        \
        family_section<B, 2, T, V>                                 \
  }
#else
#define SECTION_KERNELS(B, T, V)                                   \
  {                                                                \
    family_section<B, 0, T, V>, family_section<B, 0, T, V>,        \
        family_section<B, 0, T, V>                                 \
  }
#endif
#define F32_EVEN_V (F32_PAIRS ? 2 : 1)
#define FAMILY_KERNELS(B)                                               \
  {                                                                     \
    {SECTION_KERNELS(B, float, 1), SECTION_KERNELS(B, float, F32_EVEN_V)}, \
        {SECTION_KERNELS(B, bf16_t, 1), SECTION_KERNELS(B, bf16_t, 2)}  \
  }
static const Kernel kKernels[2][2][2][N_SECTIONS] = {FAMILY_KERNELS(true),
                                                     FAMILY_KERNELS(false)};
#define N_KERNELS (2 * 2 * 2 * N_SECTIONS)

static const Kernel& kernel_at(int q) {
  return kKernels[q / (4 * N_SECTIONS)][(q / (2 * N_SECTIONS)) % 2]
                 [(q / N_SECTIONS) % 2][q % N_SECTIONS];
}

// Whether a launch takes two z cells a thread: rows of an even n3 are
// aligned to words of two cells; bf16 always pairs them, float32 where
// F32_PAIRS says.
static bool pairs_for(int bf16, int n3) {
  return n3 % 2 == 0 && (bf16 || F32_PAIRS);
}

// Dynamic shared memory of a launch (Ring<T, V>::bytes) by storage and
// cells a thread.
static int launch_smem(int bf16, bool pairs, bool j) {
  switch (bf16 * 2 + (pairs ? 1 : 0)) {
    case 0:
      return Ring<float, 1>::bytes(j);
    case 1:
      return Ring<float, F32_EVEN_V>::bytes(j);
    case 2:
      return Ring<bf16_t, 1>::bytes(j);
    default:
      return Ring<bf16_t, 2>::bytes(j);
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
    cudaFuncAttributes a;
    err = cudaFuncGetAttributes(&a, k);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(
          k, cudaFuncAttributeMaxDynamicSharedMemorySize,
          most - static_cast<int>(a.sharedSizeBytes));
    }
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
  if (p->n_rec < 0 || p->n_rec > MAX_REC) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  for (int q = 0; q < N_SECTIONS; ++q) {
    if (p->n_item[q] < 0) {
      return static_cast<int>(cudaErrorInvalidConfiguration);
    }
  }
  const bool pairs = pairs_for(p->g.bf16, p->g.n[2]);
  if (pairs != (p->pairs != 0)) {  // a plan made for another tile width
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bf16 = p->g.bf16 ? 1 : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int first = 0;
  bool launched = false;
  for (int q = 0; q < N_SECTIONS; ++q) {  // in the plan's order
    const int n = p->n_item[q];
    if (n > 0) {
      int at = first;
      void* args[] = {const_cast<Params*>(p), &at};
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(n);
      cfg.blockDim = dim3(NT);
      cfg.dynamicSmemBytes =
          launch_smem(bf16, pairs, p->dr.Jin[0] != nullptr);
      cfg.stream = s;
      // a section's kernel may overlap the one before (programmatic
      // dependent launch): they write disjoint cells and read only the
      // launch's inputs; the first waits for all earlier work on the
      // stream, as every later launch on it waits for this one
      cudaLaunchAttribute attr;
      attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
      attr.val.programmaticStreamSerializationAllowed = 1;
      cfg.attrs = &attr;
      cfg.numAttrs = OVERLAP && launched ? 1 : 0;
      const Kernel k = kKernels[backward ? 0 : 1][bf16][pairs ? 1 : 0][q];
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
// rows, tile columns (also the alignment of the z cuts), two cells a
// thread (1) or one}.
int fdtd_family_tile(int bf16, int n3, int* out) {
  const bool pairs = pairs_for(bf16, n3);
  out[0] = TY;
  out[1] = 32 * (pairs ? 2 : 1);
  out[2] = pairs ? 1 : 0;
  return 0;
}

// Per kernel of kKernels in its order (family, storage, cells a thread,
// section), four ints: registers a thread, local (spill) bytes a thread,
// resident blocks an SM (without J or K), static shared bytes.
int fdtd_family_occupancy(int* out) {
  cudaError_t err = set_attributes();
  for (int q = 0; q < N_KERNELS && err == cudaSuccess; ++q) {
    const Kernel k = kernel_at(q);
    cudaFuncAttributes a;
    err = cudaFuncGetAttributes(&a, k);
    int blocks = 0;
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, k, NT,
          launch_smem((q / (2 * N_SECTIONS)) % 2, (q / N_SECTIONS) % 2,
                      false));
    }
    out[4 * q] = a.numRegs;
    out[4 * q + 1] = static_cast<int>(a.localSizeBytes);
    out[4 * q + 2] = blocks;
    out[4 * q + 3] = static_cast<int>(a.sharedSizeBytes);
  }
  return static_cast<int>(err);
}

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
