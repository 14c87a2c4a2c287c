// Temporal-blocked packed pass of the 3D Yee scheme at depth k = 2, for
// Hopper (sm_90a): one call advances E and H by two leapfrog steps.
//
// Replaces the Pallas TPU kernel
// fdtd3d_tpu/ops/pallas_packed_tb.py::make_packed_tb_step (builder :520,
// kernel body :900, pallas_call :1320; sharded parts :1339-1788) for 3D
// float32 and bf16 storage runs at k = 2, unsharded and on a shard.
//
// What one call computes, on the stacked layout E, H = (3, n1, n2, n3)
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
// The march. Generation 1 never reaches device memory. A thread block
// owns a work item of the host's plan (ops/packed_tb.py::plan_items): a
// (y, z) tile of at most (BY - 4) x (BZ - 4) owned cells over an x
// segment [x0, x1). One thread per (y, z) column of the tile plus a
// 2-cell halo on each side marches x (from x0 - 1 to x1 + 1, for
// generation 1's halo planes) and, at plane i, computes in four phases
// separated by barriers E1(i), H1(i-1), E2(i-1), H2(i-2) (the
// reference's phase lags). E reads H at x-1 and H reads E at x+1, so
// depth-2 shared-memory plane rings for E1, H1 and E2 suffice. Each phase
// runs on a region that shrinks by one halo cell on the side its stencil
// reads: E1 on [1, W), H1 on [1, W-1), E2 on [2, W-1), H2 on [2, W-2) =
// the owned tile (W the tile's window, owned + 4), so halo cells are
// computed redundantly for generation 1 with their own sources, psi and
// walls: every decision is taken on global coordinates.
//
// The design for the H100. Each choice against its alternative in one
// call of scripts/tb_variants.py (ms a pass at 256^3 on
// vacuum3D_tfsf's state / on one lane of the Mie example at 512^3;
// NVIDIA H100 80GB HBM3, 700 W; PERF.md):
//
// 1. Occupancy. The plan's items run in sections, one kernel each, built
//    from one march (tb_section): the items whose computed cells touch
//    no CPML slab (most of the volume) in a kernel with the CPML code
//    and the psi state compiled out, under __launch_bounds__(NT,
//    INNER_BLOCKS = 2): 64 registers, two resident 512-thread blocks (32
//    warps) an SM (0.967 / 6.25 against 1.097 / 7.23 at one block); the
//    slab items in edge kernels specialised by the axes whose slab they
//    touch (AX: x, y, z alone, or several), each keeping only those
//    axes' generation-1 psi rings (0.967 / 6.25 against 1.059 / 6.76 for
//    one general kernel). The edge kernels run one block an SM with no
//    register cap (105-118 registers, no spills); at two (64 registers,
//    24-168 bytes of spills) the single-axis ones take 1.033 / 6.22, the
//    general one 1.002 / 6.30. Items whose cells
//    read coefficient grids run in builds with the grids' rings, one
//    block an SM.
// 2. Asynchronous generation-0 loads. H0, E0 (the E coefficient grids
//    and Drude J0 in the grid builds, and the rows of the y- and
//    z-normal TFSF records that cross the tile) stream into
//    shared-memory rings PIPE = 2 planes ahead of the march, by cp.async
//    (4 bytes a thread: each thread copies its own column, so no
//    register holds the operand). Each plane's copies are one commit
//    group; `cp.async.wait_group PIPE` before the barrier that opens the
//    plane completes them, and that barrier, which the march needs
//    anyway, publishes them to the block (so no mbarrier is needed). A
//    ring slot is refilled only after the barrier that follows its last
//    reader. One plane ahead measures the same (0.965); three cost one
//    block an SM (1.114). The edge kernels' generation-0 psi stays a
//    one-plane register prefetch, and their CPML profiles sit in shared
//    memory.
// 3. Balance. The plan cuts each axis into its CPML bands and interior
//    pieces, so slab work is confined to thin items; x segments of 48
//    planes (16: 1.020, 32: 0.980, 64: 0.990); each section's items
//    heaviest first (blockIdx.x follows the plan, and the block
//    scheduler hands blocks out in that order; x, y, z order: 1.042). A
//    section's kernel may start on the SMs its predecessor leaves free
//    (programmatic dependent launch; without: 1.237 / 6.50): the
//    sections write disjoint cells and read only the source buffers. A
//    z-band item runs in a transposed block (BZ / 2 threads along z, 2 BY
//    along y), which fills its lanes (without: 1.107 / 6.56). Items
//    outside the box where the coefficient grids differ from their
//    background run the scalar-coefficient build (without: 11.69 on the
//    Mie lane).
// 4. Halo. The block stays 32 (z) x 16 (y) threads with a 2-cell halo
//    (32 x 32 threads, 1.31 columns computed a column owned against
//    1.52: 1.250; 8 x 32: 1.119). The interior tiles are 24 cells wide
//    at multiples of 8 along z, so the rows of owned cells the kernel
//    writes start and end on 32-byte sectors (28 wide anywhere: 1.025 /
//    6.80).
//
// Records cost nothing where they are absent: each family's record
// table lives in shared memory with per-component and x-normal bit
// masks; a column holds the bits of the y- and z-normal records whose
// plane holds it, a table the bits of the x-normal records on each
// plane of the item, and a cell adds the records of those bits in table
// order.
//
// Lanes (the reference's batch=B build of make_packed_tb_step, vmapped
// over a lane-major grid dimension): one call advances `lanes` same-shape
// scenarios by two steps. Block b runs item b / lanes on lane b % lanes:
// every lane runs exactly the items of a solo call, in the same kernels,
// and every base pointer steps by a 64-bit lane stride: fields and J by
// 3 n1 n2 n3, psi by its slab extent, a coefficient grid by its own
// stride (0 when shared), the record terms by one row of `total` per lane
// and generation, the point source's drive by two values per lane. The
// plan, the record table and its masks depend on geometry (and the
// grids' box, the same for every lane) only. A solo run is lanes = 1
// (MULTI = false).
//
// bf16 storage (Params.bf16, csrc/storage.cuh): E and H are bf16 words in
// device memory, widened to float where they enter the rings; all the
// arithmetic, the psi and J state and the coefficients stay float32, and
// only generation 2 is rounded to bf16, where it is stored (the rings of
// generation 1 and of E2, which H2 reads, hold floats), as the
// reference's tb kernel rounds only at g == k (pallas_packed_tb.py:1200,
// :1258). A bf16 cell is a 2-byte word, below cp.async's 4 bytes, and the
// tiles start at any z: the bf16 build loads each thread's words of
// plane i + PIPE into registers at the top of iteration i and widens
// them into the float rings at its end, after the phases that read the
// slots they refill; the coefficient, J and record rings keep cp.async.
// The rings and shared memory are the float build's.
//
// Shards (Params.shard; template SHARD, one lane): a shard of a
// decomposed run advances its box on its frame, the box grown by GHOST =
// 2 cells on each side with a neighbour; the call's n1, n2, n3, records
// and point source are the frame's (ops/packed_tb.py::prepare_shard), m
// and the profiles the shard's own, its CPML slab decisions taken on the
// global grid (Params.base, ng), so an interior shard's identity slab
// rows run the plain code. The march is the unsharded one on the frame:
// generation 1 is computed in the halo from the neighbours'
// generation-0 cells, so H(t+2) on the box's upper edge reads the true
// E(t+2) and no fix follows. That route rather than the reference's
// wedge pre-pass and generation ghosts (pallas_packed_tb.py:1537, :1612,
// :1649): the march already recomputes a 2-cell halo between blocks, so
// the frame needs only generation-0 cells, at the cost of two planes a
// side a pass. What the SHARD build changes: a column's generation-0
// cells (E, H, J, the coefficient grids) come from the shard's own
// buffers inside its box and from the ghost buffers beyond it (gcol,
// field_at: the later axis's buffer holds the corners), psi of an axis
// from the shard's slab stack or the ghost buffers of another axis
// (psi_load: one branch per axis, 32-bit offsets; a ghost plane of an
// axis lies in no slab of that axis), the stores go to the shard's own
// stacks (psi_own), and the frame's edges are PEC walls on closed sides
// only. The arithmetic is the unsharded build's, products contracted
// into FMAs by nvcc: a shard's pass agrees with its plain version at the
// pass's gate (a sharded run has equalled the unsharded one bit for bit
// on the card, PERF.md). psi_load branches per axis because an address
// built from runtime-indexed arrays spilled 616 bytes in the general
// edge kernel, whose items then set a shard's pass (1.04 ms against
// 0.35, scripts/tb_variants.py --sharded). The parameter block is
// __grid_constant__: the sharded builds index its ghost pointers with
// per-column values (without it, 24 bytes of spills in the grid edge
// kernel at the same time).
//
// In place would be wrong: a block reads halo columns of E, H, psi and J
// that a neighbouring block writes, so the call reads only the source
// buffers and writes only the destination ones (the caller ping-pongs).
//
// What bounds it on the card: memory bytes. A call must read E and H
// once and write them once (12 volumes, 48 B/cell for two steps, 24
// B/cell a step, against the two-launch twin's 72) plus the psi slabs;
// the halo columns are re-read (mostly from L2). About 120 flops a cell
// for the two steps, far below the card's ~20 flops per byte.
//
// Build knobs (-D): BY, BZ (threads of a block, halo included), PIPE,
// INNER_BLOCKS, EDGE_BLOCKS, SINGLE_BLOCKS, OVERLAP; TB_BLOCK_TIMER
// records each block's %globaltimer start and end and its SM
// (fdtd_tb_blocks).
//
// Offsets are 64-bit (32-bit inside one lane's psi stack). Every entry
// returns cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "storage.cuh"

#define MAX_REC 16   // mirrors fdtd3d_torch/ops/packed_tb.py
#define PLAN_COLS 8  // ints a plan row: j0, k0, ny, nz, x0, x1, class, pad
#define MAX_PLANES 512  // owned x planes of an item at most (the plan's)
#define MAX_SLAB_SUM 256  // CPML planes a side summed over the axes
#ifndef BZ
#define BZ 32  // block extent along z (threadIdx.x), halo included
#endif
#ifndef BY
#define BY 16  // block extent along y (threadIdx.y), halo included
#endif
#ifndef PIPE
#define PIPE 2  // generation-0 planes in flight ahead of the march
#endif
#ifndef INNER_BLOCKS
#define INNER_BLOCKS 2  // resident blocks an SM the inner kernel is built for
#endif
#ifndef EDGE_BLOCKS
#define EDGE_BLOCKS 1  // the general edge kernel (slabs of several axes)
#endif
#ifndef SINGLE_BLOCKS
#define SINGLE_BLOCKS 1  // the edge kernels of items in one axis's slab
#endif
#define SECTIONS 7
#ifndef OVERLAP
#define OVERLAP 1  // a section's kernel may start while the one before ends
#endif
#define HALO 2
#define GHOST 2  // planes a shard reads beyond an open side (ops/packed_tb.py)
#define NT (BZ * BY)
#define PLANE (3 * NT)  // floats of one ring plane (three components)
#define RING ((PIPE + 2) <= 4 ? 4 : 8)  // generation-0 ring planes
#define REC_SLOTS (NT >= 512 ? 4 : NT / 128)  // staged records a family
#define REC_RING 8   // staged record planes (PIPE + 3 at most)
#define REC_ROW 32   // floats of a staged record row (>= BZ and BY)
#define REC_STAGE (2 * REC_SLOTS * 2 * REC_RING * REC_ROW)  // floats
#if PIPE < 1 || PIPE + 3 > REC_RING
#error "PIPE must lie in [1, 5]"
#endif
#if BZ > REC_ROW || BY > REC_ROW || NT < 256
#error "a staged record row holds at most REC_ROW columns"
#endif
// The transposed layout (BZ / 2 threads along z, 2 BY along y) of the
// edge kernel's items in a z band; built when its rows fit a staged row.
#define ZBAND (2 * BY <= REC_ROW && BZ % 2 == 0)

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
  const void* E0;         // stacked (lanes, 3, n1, n2, n3), read only
  const void* H0;         // (float or bf16 words)
  const float* J0;        // Drude J or nullptr
  void* E2;               // destination stacks, written only
  void* H2;
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
  const int* plan;        // (items, PLAN_COLS) work items, by section
  Family fe, fh;
  Coef kj[3];             // Drude
  Coef bj[3];
  int m[3];               // slab planes per side, 0 = no CPML on the axis
  int pc, pi, pj, pk;     // point source: E component (-1: none), cell
  float drive[2];         // one lane: amplitude * waveform per generation
  int n1, n2, n3;
  int lanes;              // scenarios advanced by one call
  int n_item[SECTIONS];   // items of each section, in launch order (see
                          // kKernels)
  float inv_dx;
  int bf16;               // E and H are bf16 words (else float32)
  // a shard of a decomposed run (shard != 0, one lane; see "Shards" in
  // the header): n1, n2, n3, the records and the point source are the
  // frame's; the buffers *0, *2, the coefficient grids, the psi stacks
  // and m, prof the shard's own (local extent nl, slab planes m = ml a
  // side, taken where the global grid's slabs are)
  int shard;
  int lo[3];              // the frame's planes below the shard's box
  int nl[3];              // the shard's extent
  int open_lo[3];         // a neighbour below / above: no PEC wall there
  int open_hi[3];
  int base[3];            // the frame's first cell on the global grid
  int ng[3];              // the global grid: the CPML slabs are its own
  const void* gE[3][2];   // ghost planes by axis and side (below, above):
  const void* gH[3][2];   // E, H (float or bf16 words), J (float), and
  const void* gJ[3][2];   // each psi stack's, gpE[a][c][side] of axis a's
  const float* gpE[3][3][2];
  const float* gpH[3][3][2];
  // the coefficient grids' ghost planes, gco[slot][c][axis][side]: slots
  // E a, b, kj, bj, H a, b (ops/packed_tb.py GRID_SLOTS); the grids
  // themselves (Coef.grid) are the shard's own
  const void* gco[6][3][3][2];
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

// Offset of cell (i, j, k) in one lane's psi stack of axis a, row
// `row`, at slab plane q (a lane's stack holds fewer than 2^31 values:
// the wrapper checks).
__device__ __forceinline__ int psi_offset(int a, int row, int q, int i,
                                          int j, int k, int n1, int n2,
                                          int n3, int m2) {
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

// One family's record table in shared memory: the kernel copies it from
// the parameter block once, because indexing the parameter block with a
// runtime index is slow; with the bits of each component's records and
// of the x-normal records.
// A y-normal record whose plane crosses the block's window adds, at
// plane x, one row of terms along z (the window's columns); a z-normal
// one a row along y. The first REC_SLOTS such records of a family are
// staged: their rows of both generations stream into a shared ring
// (REC_RING planes, PIPE ahead, with the fields), so a record cell reads
// its term from shared memory; slot[r] is record r's slot or -1.
struct RecTable {
  int comp[MAX_REC];
  int axis[MAX_REC];
  int plane[MAX_REC];
  long long off[MAX_REC];
  int slot[MAX_REC];
  int srec[REC_SLOTS];  // the record of each slot
  int nslot;
  unsigned cbits[3];
  unsigned xbits;
};

// The window covers rows [jw, jw + wy) and columns [kw, kw + wz).
__device__ __forceinline__ void copy_table(const Family& f, int tid, int jw,
                                           int wy, int kw, int wz,
                                           RecTable& rt) {
  if (tid < f.n_rec) {
    rt.comp[tid] = f.rec[tid].comp;
    rt.axis[tid] = f.rec[tid].axis;
    rt.plane[tid] = f.rec[tid].plane;
    rt.off[tid] = f.rec[tid].off;
  }
  if (tid == 0) {
    unsigned cb0 = 0u, cb1 = 0u, cb2 = 0u, xb = 0u;
    int ns = 0;
#pragma unroll
    for (int r = 0; r < MAX_REC; ++r) {
      if (r < f.n_rec) {
        const unsigned bit = 1u << r;
        const int c = f.rec[r].comp;
        const int a = f.rec[r].axis;
        const int q = f.rec[r].plane;
        cb0 |= c == 0 ? bit : 0u;
        cb1 |= c == 1 ? bit : 0u;
        cb2 |= c == 2 ? bit : 0u;
        xb |= a == 0 ? bit : 0u;
        const bool crosses = (a == 1 && q >= jw && q < jw + wy) ||
                             (a == 2 && q >= kw && q < kw + wz);
        rt.slot[r] = -1;
        if (crosses && ns < REC_SLOTS) {
          rt.slot[r] = ns;
          rt.srec[ns] = r;
          ++ns;
        }
      }
    }
    rt.nslot = ns;
    rt.cbits[0] = cb0;
    rt.cbits[1] = cb1;
    rt.cbits[2] = cb2;
    rt.xbits = xb;
  }
}

// The y- and z-normal records whose plane holds column (j, k).
__device__ __forceinline__ unsigned column_bits(const RecTable& rt,
                                                int n_rec, int j, int k) {
  unsigned bits = 0u;
  for (int r = 0; r < n_rec; ++r) {
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

// The row of generation g of this lane in `terms` (a single-lane launch
// reads row g).
template <bool MULTI>
__device__ __forceinline__ int64_t terms_row(const Params& p, int g,
                                             int lane) {
  return MULTI ? (int64_t)(g * p.lanes + lane) * p.total
               : (int64_t)g * p.total;
}

// Offset of a staged row: family f, slot s, generation g, plane x.
__device__ __forceinline__ int stage_row(int f, int s, int g, int x) {
  return (((f * REC_SLOTS + s) * 2 + g) * REC_RING + (x & (REC_RING - 1))) *
         REC_ROW;
}

// acc plus the record terms of component c at cell (x, j, k) among the
// records `bits`, in table order, for generation g of this lane: a
// staged record from family f's rows in `stage` (the thread's place in
// the window, ly = tid / ZW, lz = tid % ZW, picks the value), the others
// from `terms`.
template <bool MULTI, int ZW>
__device__ __forceinline__ float add_records(
    const Params& p, const RecTable& rt, const float* stage, int f,
    unsigned bits, int c, int g, int lane, int x, int j, int k, int tid,
    float acc) {
  for (unsigned m = bits & rt.cbits[c]; m; m &= m - 1) {
    const int r = __ffs(m) - 1;
    const int s = rt.slot[r];
    if (s >= 0) {
      acc += stage[stage_row(f, s, g, x) +
                   (rt.axis[r] == 1 ? tid % ZW : tid / ZW)];
    } else {
      acc += p.terms[terms_row<MULTI>(p, g, lane) + rt.off[r] +
                     plane_index(rt.axis[r], x, j, k, p.n2, p.n3)];
    }
  }
  return acc;
}

// Facts of a thread's column, fixed over the march.
struct Col {
  int j, k;
  int qy, qz;     // slab plane of j and of k, -1 outside (or no CPML)
  unsigned wall;  // E components that a y or z PEC wall zeroes (bit c)
  bool ym, zm;    // j > 0, k > 0: the backward neighbour is in the domain
  bool yp, zp;    // j < n2 - 1, k < n3 - 1: the forward one is
};

// Facts of a phase's plane x, the same for every thread.
struct Pl {
  int x;
  int qx;         // slab plane of x, -1 outside (or no CPML)
  bool xm, xp;    // x > 0, x < n1 - 1
  unsigned wall;  // E components that an x PEC wall zeroes
};

template <bool SHARD>
__device__ __forceinline__ Pl plane(const Params& p, int x) {
  Pl pl;
  pl.x = x;
  if constexpr (SHARD) {
    pl.qx = p.m[0] > 0 ? slab_plane(x + p.base[0], p.ng[0], p.m[0]) : -1;
  } else {
    pl.qx = p.m[0] > 0 ? slab_plane(x, p.n1, p.m[0]) : -1;
  }
  pl.xm = x > 0;
  pl.xp = x < p.n1 - 1;
  if constexpr (SHARD) {  // the frame's edges are walls on closed sides only
    pl.wall = ((x == 0 && !p.open_lo[0]) || (x == p.n1 - 1 && !p.open_hi[0]))
                  ? 6u
                  : 0u;
  } else {
    pl.wall = (x == 0 || x == p.n1 - 1) ? 6u : 0u;
  }
  return pl;
}

// A shard's generation-0 field column: where the frame's column (j, k)
// lives in the shard's buffers. sel 0: a column of the shard's box, in
// the carry or, beyond the box along x, in the x ghost planes; 1, 2: a
// column of the y or z ghost planes (side 0 below, 1 above), whose
// buffers span the frame along the earlier axes (the corners). base:
// the column's offset at x plane 0 (of the box for sel 0, of the frame
// otherwise); ps: between x planes; cs: between components (sel 1, 2).
struct GCol {
  int sel, side;
  int64_t base, ps, cs;
};

__device__ __forceinline__ GCol gcol(const Params& p, int j, int k) {
  GCol g;
  const int lj = j - p.lo[1], lk = k - p.lo[2];
  const int64_t n3 = p.nl[2];
  g.side = 0;
  g.cs = 0;
  if (lk < 0 || lk >= p.nl[2]) {
    g.sel = 2;
    g.side = lk >= 0;
    g.base = (int64_t)j * GHOST + (g.side ? lk - p.nl[2] : lk + GHOST);
    g.ps = (int64_t)p.n2 * GHOST;
    g.cs = (int64_t)p.n1 * g.ps;
  } else if (lj < 0 || lj >= p.nl[1]) {
    g.sel = 1;
    g.side = lj >= 0;
    g.base = (int64_t)(g.side ? lj - p.nl[1] : lj + GHOST) * n3 + lk;
    g.ps = GHOST * n3;
    g.cs = (int64_t)p.n1 * g.ps;
  } else {
    g.sel = 0;
    g.base = (int64_t)lj * n3 + lk;
    g.ps = (int64_t)p.nl[1] * n3;
  }
  return g;
}

// The generation-0 cell of component 0 of a field at frame plane x of a
// shard's column (the carry `local`, or its ghost planes `g`), and the
// distance between its components in `cs`.
template <typename T>
__device__ __forceinline__ const T* field_at(const Params& p,
                                             const void* local,
                                             const void* const (&g)[3][2],
                                             const GCol& gc, int x,
                                             int64_t& cs) {
  if (gc.sel) {
    cs = gc.cs;
    return static_cast<const T*>(g[gc.sel][gc.side]) + gc.base +
           (int64_t)x * gc.ps;
  }
  const int lx = x - p.lo[0];
  if (lx < 0 || lx >= p.nl[0]) {
    cs = GHOST * gc.ps;
    return static_cast<const T*>(g[0][lx >= 0]) +
           (int64_t)(lx < 0 ? lx + GHOST : lx - p.nl[0]) * gc.ps + gc.base;
  }
  cs = (int64_t)p.nl[0] * gc.ps;
  return static_cast<const T*>(local) + (int64_t)lx * gc.ps + gc.base;
}

// A shard's coefficient at frame plane x of its column: its own grid
// inside the box, the grid's ghost planes beyond it; the scalar where the
// coefficient is one.
__device__ __forceinline__ const float* grid_at(const Params& p,
                                                const float* local,
                                                const void* const (&g)[3][2],
                                                const GCol& gc, int x) {
  int64_t cs;
  return field_at<float>(p, local, g, gc, x, cs);
}
__device__ __forceinline__ float gval(const Params& p, const Coef& c,
                                      const void* const (&g)[3][2],
                                      const GCol& gc, int x) {
  return c.grid ? *grid_at(p, c.grid, g, gc, x) : c.val;
}

// A shard's psi of axis a, row `row`, at slab plane q of box cell (lx,
// lj, lk): its offset in the shard's own stack (2 m planes along a, the
// box along the other axes; a shard's stack holds fewer than 2^31
// values: the wrapper checks).
__device__ __forceinline__ int psi_own(const Params& p, int a, int row,
                                       int q, int lx, int lj, int lk) {
  const int m2 = 2 * p.m[a];
  if (a == 0) return ((row * m2 + q) * p.nl[1] + lj) * p.nl[2] + lk;
  if (a == 1) return ((row * p.nl[0] + lx) * m2 + q) * p.nl[2] + lk;
  return ((row * p.nl[0] + lx) * p.nl[1] + lj) * m2 + q;
}

// A shard's generation-0 psi of axis a, row `row`, at slab plane q of
// frame cell (x, j, k) (the global grid's slab, which the shard holds: a
// cell beyond its box along a lies in no slab of a, shards_fit): from
// the shard's own stack `own` inside its box; beyond it along another
// axis c (the later one where both are), from c's ghost planes g[c]
// [side], which span the frame along the earlier axes, as the fields' do.
// a is a constant once the callers' loops unroll, so each call keeps one
// branch per axis.
__device__ __forceinline__ float psi_load(const Params& p, int a, int row,
                                          int q, int x, int j, int k,
                                          const float* own,
                                          const float* const (&g)[3][2]) {
  const int lx = x - p.lo[0], lj = j - p.lo[1], lk = k - p.lo[2];
  const bool ox = (unsigned)lx >= (unsigned)p.nl[0];
  const bool oy = (unsigned)lj >= (unsigned)p.nl[1];
  const bool oz = (unsigned)lk >= (unsigned)p.nl[2];
  const int gx = lx < 0 ? lx + GHOST : lx - p.nl[0];
  const int gy = lj < 0 ? lj + GHOST : lj - p.nl[1];
  const int gz = lk < 0 ? lk + GHOST : lk - p.nl[2];
  const int m2 = 2 * p.m[a];
  const float* const zg = g[2][lk >= 0];
  const float* const yg = g[1][lj >= 0];
  const float* const xg = g[0][lx >= 0];
  if (a == 0) {
    if (oz) return zg[((row * m2 + q) * p.n2 + j) * GHOST + gz];
    if (oy) return yg[((row * m2 + q) * GHOST + gy) * p.nl[2] + lk];
  } else if (a == 1) {
    if (oz) return zg[((row * p.n1 + x) * m2 + q) * GHOST + gz];
    if (ox) return xg[((row * GHOST + gx) * m2 + q) * p.nl[2] + lk];
  } else {
    if (oy) return yg[((row * p.n1 + x) * GHOST + gy) * m2 + q];
    if (ox) return xg[((row * GHOST + gx) * p.nl[1] + lj) * m2 + q];
  }
  return own[psi_own(p, a, row, q, lx, lj, lk)];
}

__device__ __forceinline__ int slab_of(const Col& col, const Pl& pl,
                                       int a) {
  return a == 0 ? pl.qx : (a == 1 ? col.qy : col.qz);
}

// psi of generation 0 at the cell of column `col` on plane `pl` of this
// lane from the stacks `ps`, for every curl term (2 c + t) whose axis (of
// the axes AX) has a CPML slab holding the cell; the other entries of
// `out` are left as they are.
template <int AX, bool SHARD>
__device__ __forceinline__ void load_psi(const Params& p,
                                         const float* const (&ps)[3],
                                         const float* const (&gp)[3][3][2],
                                         int lane, const Col& col,
                                         const Pl& pl, float (&out)[6]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int a = term_axis(c, t);
      const int q = (AX >> a) & 1 ? slab_of(col, pl, a) : -1;
      if (SHARD && q >= 0) {
        out[2 * c + t] = psi_load(p, a, c < a ? c : c - 1, q, pl.x, col.j,
                                  col.k, ps[a], gp[a]);
      } else if (q >= 0) {
        out[2 * c + t] =
            ps[a][lane * p.psi_lane[a] +
                  psi_offset(a, c < a ? c : c - 1, q, pl.x, col.j, col.k,
                             p.n1, p.n2, p.n3, 2 * p.m[a])];
      }
    }
  }
}

// Where a cell's operands beyond the field rings come from: the staged
// record rows, and (GRID) the E coefficients' ring slot of the cell's
// plane at this thread (ca of component c at [c NT], cb at [(3 + c) NT];
// a grid that is absent is the scalar).
struct Src {
  const float* stage;
  const float* cf;
  const float* prof;  // the CPML profiles in shared memory (edge kernel)
};

// Offset of family f's profile rows of axis a in the shared profiles:
// per family and axis with a slab, rows b, c, 1/kappa of 2 m[a] values.
__device__ __forceinline__ int prof_offset(const Params& p, int f, int a) {
  const int msum = p.m[0] + p.m[1] + p.m[2];
  return 6 * (f * msum + (a > 0 ? p.m[0] : 0) + (a > 1 ? p.m[1] : 0));
}

// A coefficient: a grid value, or (GRID = false: no grid in the call)
// the scalar.
template <bool GRID>
__device__ __forceinline__ float cval(const Coef& c, int lane,
                                      int64_t cell) {
  return GRID ? coef(c, lane, cell) : c.val;
}

// ca or cb of an E component: from the coefficient ring (GRID), else
// the scalar.
template <bool GRID>
__device__ __forceinline__ float eval(const Coef& c, const float* cf,
                                      int at) {
  return GRID && c.grid ? cf[at] : c.val;
}

// One E cell of generation G + 1 at this thread's column.
// hr: the ring of the H generation G (plane x at offset s0, x-1 at s1);
// old: E(G) of the cell; drive: this lane's point-source values (a
// one-lane launch reads p.drive, a kernel parameter, instead); point:
// the cell is the point source's. G = 0 takes generation 0's psi and J
// from psi0/j0 and leaves generation 1's in pe/jr; G = 1 takes them from
// pe/jr and, when `store`, writes generation 2's to device memory.
// AX: the axes whose slab terms are compiled in (bit a: axis a; 0 for
// none), REC = false compiles the records out, GRID = false the
// coefficient grids and Drude J.
template <int G, int AX, bool REC, bool GRID, bool MULTI, int ZW, bool SHARD>
__device__ __forceinline__ void e_cell(
    const Params& p, const RecTable& rt, unsigned bits, const float* hr,
    int s0, int s1, const Col& col, const Pl& pl, const Src& src, int lane,
    int64_t cell, int64_t lcell, const GCol& gc, int tid,
    const float (&old)[3], const float (&drive)[2],
    bool point, const float (&psi0)[6], const float (&j0)[3],
    float (&pe)[6], float (&jr)[3], float (&out)[3], bool store) {
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
        prev = pl.xm ? hr[s1 + d * NT + tid] : 0.f;
      } else if (a == 1) {
        prev = col.ym ? here[-ZW] : 0.f;
      } else {
        prev = col.zm ? here[-1] : 0.f;
      }
      const float dfa = (here[0] - prev) * p.inv_dx;
      if ((AX >> a) & 1) {
        const int q = slab_of(col, pl, a);
        if (q >= 0) {
          const int m = p.m[a];
          const float* pr = src.prof + prof_offset(p, 0, a);
          const float ps_old = G == 0 ? psi0[2 * c + t] : pe[2 * c + t];
          const float psi = pr[q] * ps_old + pr[2 * m + q] * dfa;
          if (G == 0) {
            pe[2 * c + t] = psi;
          } else if (SHARD && store) {  // an owned cell: the shard's stack
            p.psE2[a][psi_own(p, a, c < a ? c : c - 1, q, pl.x - p.lo[0],
                               col.j - p.lo[1], col.k - p.lo[2])] = psi;
          } else if (store) {
            p.psE2[a][lane * p.psi_lane[a] +
                      psi_offset(a, c < a ? c : c - 1, q, pl.x, col.j,
                                 col.k, p.n1, p.n2, p.n3, 2 * m)] = psi;
          }
          acc += s * ((pr[4 * m + q] - 1.f) * dfa + psi);
        }
      }
      acc += s * dfa;
    }
    if (REC) {
      acc = add_records<MULTI, ZW>(p, rt, src.stage, 0, bits, c, G, lane,
                                   pl.x, col.j, col.k, tid, acc);
    }
    if (GRID && p.J0) {
      const float jo = G == 0 ? j0[c] : jr[c];
      const float jn =
          SHARD ? gval(p, p.kj[c], p.gco[2][c], gc, pl.x) * jo +
                      gval(p, p.bj[c], p.gco[3][c], gc, pl.x) * old[c]
                : coef(p.kj[c], lane, cell) * jo +
                      coef(p.bj[c], lane, cell) * old[c];
      if (G == 0) {
        jr[c] = jn;
      } else if (SHARD && store) {
        p.J2[c * ((int64_t)p.nl[0] * p.nl[1] * p.nl[2]) + lcell] = jn;
      } else if (store) {
        p.J2[(int64_t)lane * p.field_lane + c * vol + cell] = jn;
      }
      acc -= jn;
    }
    if (c == p.pc && point) {
      acc += MULTI ? drive[G] : p.drive[G];
    }
    const float v = eval<GRID>(p.fe.a[c], src.cf, c * NT) * old[c] +
                    eval<GRID>(p.fe.b[c], src.cf, (3 + c) * NT) * acc;
    // PEC walls: tangential E vanishes on the walls of the two axes
    // other than its own.
    out[c] = ((col.wall | pl.wall) >> c) & 1u ? 0.f : v;
  }
}

// One H cell of generation G + 1 at this thread's column.
// er: the ring of the E generation G + 1 (plane x at offset s0, x+1 at
// s1); old: H(G) of the cell; psi, AX, REC and GRID as in e_cell.
template <int G, int AX, bool REC, bool GRID, bool MULTI, int ZW, bool SHARD>
__device__ __forceinline__ void h_cell(
    const Params& p, const RecTable& rt, unsigned bits, const float* er,
    int s0, int s1, const Col& col, const Pl& pl, const Src& src, int lane,
    int64_t cell, int64_t lcell, const GCol& gc, int tid,
    const float (&old)[3], const float (&psi0)[6],
    float (&ph)[6], float (&out)[3], bool store) {
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
        next = pl.xp ? er[s1 + d * NT + tid] : 0.f;
      } else if (a == 1) {
        next = col.yp ? here[ZW] : 0.f;
      } else {
        next = col.zp ? here[1] : 0.f;
      }
      const float dfa = (next - here[0]) * p.inv_dx;
      if ((AX >> a) & 1) {
        const int q = slab_of(col, pl, a);
        if (q >= 0) {
          const int m = p.m[a];
          const float* pr = src.prof + prof_offset(p, 1, a);
          const float ps_old = G == 0 ? psi0[2 * c + t] : ph[2 * c + t];
          const float psi = pr[q] * ps_old + pr[2 * m + q] * dfa;
          if (G == 0) {
            ph[2 * c + t] = psi;
          } else if (SHARD && store) {  // an owned cell: the shard's stack
            p.psH2[a][psi_own(p, a, c < a ? c : c - 1, q, pl.x - p.lo[0],
                               col.j - p.lo[1], col.k - p.lo[2])] = psi;
          } else if (store) {
            p.psH2[a][lane * p.psi_lane[a] +
                      psi_offset(a, c < a ? c : c - 1, q, pl.x, col.j,
                                 col.k, p.n1, p.n2, p.n3, 2 * m)] = psi;
          }
          acc += s * ((pr[4 * m + q] - 1.f) * dfa + psi);
        }
      }
      acc += s * dfa;
    }
    if (REC) {
      acc = add_records<MULTI, ZW>(p, rt, src.stage, 1, bits, c, G, lane,
                                   pl.x, col.j, col.k, tid, acc);
    }
    if (SHARD && GRID) {
      out[c] = gval(p, p.fh.a[c], p.gco[4][c], gc, pl.x) * old[c] -
               gval(p, p.fh.b[c], p.gco[5][c], gc, pl.x) * acc;
    } else {
      out[c] = cval<GRID>(p.fh.a[c], lane, cell) * old[c] -
               cval<GRID>(p.fh.b[c], lane, cell) * acc;
    }
  }
}

// The cell paths of a phase: the slab terms of the axes AX and records
// (edge kernels: a slab cell or a record cell), records only (a record
// cell of the inner kernel), neither. The branch is taken per column and
// plane.
#define E_CELL(G, ...)                                          \
  do {                                                          \
    if constexpr (AX != 0) {                                    \
      if (full) {                                               \
        e_cell<G, AX, true, GRID, MULTI, ZW, SHARD>(__VA_ARGS__);      \
      } else {                                                  \
        e_cell<G, 0, false, GRID, MULTI, ZW, SHARD>(__VA_ARGS__);      \
      }                                                         \
    } else if (full) {                                          \
      e_cell<G, 0, true, GRID, MULTI, ZW, SHARD>(__VA_ARGS__);         \
    } else {                                                    \
      e_cell<G, 0, false, GRID, MULTI, ZW, SHARD>(__VA_ARGS__);        \
    }                                                           \
  } while (0)
#define H_CELL(G, ...)                                          \
  do {                                                          \
    if constexpr (AX != 0) {                                    \
      if (full) {                                               \
        h_cell<G, AX, true, GRID, MULTI, ZW, SHARD>(__VA_ARGS__);      \
      } else {                                                  \
        h_cell<G, 0, false, GRID, MULTI, ZW, SHARD>(__VA_ARGS__);      \
      }                                                         \
    } else if (full) {                                          \
      h_cell<G, 0, true, GRID, MULTI, ZW, SHARD>(__VA_ARGS__);         \
    } else {                                                    \
      h_cell<G, 0, false, GRID, MULTI, ZW, SHARD>(__VA_ARGS__);        \
    }                                                           \
  } while (0)

#ifdef TB_BLOCK_TIMER
#define TIMER_BLOCKS 65536
__device__ unsigned long long g_tb_blocks[3 * TIMER_BLOCKS];
#endif

// A block's shared tables: each family's record table and the bits of
// its x-normal records on each plane the item marches (index x - ib).
struct Tables {
  RecTable rt[2];
  unsigned short xb[2][MAX_PLANES + 4];
};

// One work item on one lane. MULTI = false is the launch of a single
// lane (a solo run, or a batch of one): the lane is the constant 0, every
// lane offset folds away and the drive is a kernel parameter. AX: the
// axes whose CPML slabs the item's cells may touch (bit a for axis a),
// whose slab path and psi state are compiled in; 0 for the inner kernel,
// which the plan gives only items whose computed cells touch no slab.
// GRID = false compiles the coefficient grids and Drude J out. ZW: the
// block's extent along z (BZ, or BZ / 2 in the transposed layout of
// z-band items, with 2 BY along y). T: the fields' storage type.
template <bool MULTI, int AX, bool GRID, int ZW, typename T, bool SHARD>
__device__ __forceinline__ void march(const Params& p, int first_item) {
  constexpr bool EDGE = AX != 0;
  constexpr bool BF = sizeof(T) == 2;
  const T* const E0 = static_cast<const T*>(p.E0);
  const T* const H0 = static_cast<const T*>(p.H0);
  T* const E2 = static_cast<T*>(p.E2);
  T* const H2 = static_cast<T*>(p.H2);
  extern __shared__ __align__(16) float ring[];
  __shared__ Tables tab;
  float* h0r = ring;                  // H(t):   RING planes
  float* e0r = ring + RING * PLANE;   // E(t):   RING planes
  float* e1r = e0r + RING * PLANE;    // E(t+1): planes i, i-1
  float* h1r = e1r + 2 * PLANE;       // H(t+1): planes i-1, i-2
  float* e2r = h1r + 2 * PLANE;       // E(t+2): planes i-1, i-2
  float* stage = e2r + 2 * PLANE;      // staged record rows
  float* cr = stage + REC_STAGE;       // ca, cb: RING planes (GRID only)
  float* j0r = cr + RING * 2 * PLANE;  // J(t): RING planes (GRID only)
  // CPML profiles (edge kernel), after the rings the call has
  float* prof = GRID ? j0r + RING * PLANE : cr;
  RecTable& rt_e = tab.rt[0];
  RecTable& rt_h = tab.rt[1];

#ifdef TB_BLOCK_TIMER
  unsigned long long t_start;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_start));
#endif
#if OVERLAP
  // the next section's kernel reads no output of this one: it may start
  // on the SMs this kernel's last blocks leave free
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
#endif
  const int tid = threadIdx.y * BZ + threadIdx.x;
  const int lz = tid % ZW, ly = tid / ZW;
  const int lane = MULTI ? (int)(blockIdx.x % p.lanes) : 0;
  const int item = first_item + (MULTI ? (int)(blockIdx.x / p.lanes)
                                       : (int)blockIdx.x);
  const int* it = p.plan + (int64_t)PLAN_COLS * item;
  const int j0 = it[0], k0 = it[1], ny = it[2], nz = it[3];
  const int x0 = it[4], x1 = it[5];
  const int wy = ny + 2 * HALO, wz = nz + 2 * HALO;  // the tile's window
  const int jw = j0 - HALO, kw = k0 - HALO;           // its first cell
  const int n1 = p.n1, n2 = p.n2, n3 = p.n3;
  Col col;
  col.k = kw + lz;
  col.j = jw + ly;
  const int j = col.j, k = col.k;
  // the march runs from x0 - 1 (generation 1's halo plane) to x1 + 1 and
  // writes generation 2 on [x0, x1) only
  const int lim = min(n1, x1 + 2);  // planes of generation 0 read: < lim
  const int ib = max(x0 - 1, 0);    // the first iteration
  const int64_t vol = (int64_t)n1 * n2 * n3;
  const int64_t pstride = (int64_t)n2 * n3;
  const bool inside =
      ly < wy && lz < wz && j >= 0 && j < n2 && k >= 0 && k < n3;
  // the shrinking regions of the four phases (see the header)
  const bool in_e1 = inside && ly >= 1 && lz >= 1;
  const bool in_h1 = in_e1 && ly < wy - 1 && lz < wz - 1;
  const bool in_e2 = in_h1 && ly >= 2 && lz >= 2;
  const bool own = in_e2 && ly < wy - 2 && lz < wz - 2;
  const int64_t cidx = inside ? (int64_t)j * n3 + k : 0;
  // a shard's slabs are the global grid's
  col.qy = p.m[1] <= 0 ? -1
           : SHARD    ? slab_plane(j + p.base[1], p.ng[1], p.m[1])
                      : slab_plane(j, n2, p.m[1]);
  col.qz = p.m[2] <= 0 ? -1
           : SHARD    ? slab_plane(k + p.base[2], p.ng[2], p.m[2])
                      : slab_plane(k, n3, p.m[2]);
  // a shard's frame: walls on its closed edges only
  const bool y_wall = SHARD ? (j == 0 && !p.open_lo[1]) ||
                                  (j == n2 - 1 && !p.open_hi[1])
                            : j == 0 || j == n2 - 1;
  const bool z_wall = SHARD ? (k == 0 && !p.open_lo[2]) ||
                                  (k == n3 - 1 && !p.open_hi[2])
                            : k == 0 || k == n3 - 1;
  col.wall = (y_wall || z_wall ? 1u : 0u) | (z_wall ? 2u : 0u) |
             (y_wall ? 4u : 0u);
  col.ym = j > 0;
  col.zm = k > 0;
  col.yp = j < n2 - 1;
  col.zp = k < n3 - 1;
  // the lane's offset in the field and J stacks (psi and coefficient
  // grids take theirs where they are read); 0 in a single-lane launch
  const int64_t lf = lane * p.field_lane;
  // a shard: where its column's generation-0 cells live, and the volume
  // of its own stacks (the stores' component stride)
  const GCol gc = SHARD ? gcol(p, j, k) : GCol{};
  const int64_t lvol =
      SHARD ? (int64_t)p.nl[0] * p.nl[1] * p.nl[2] : vol;
  const bool pcol = j == p.pj && k == p.pk;
  // a launch of several lanes reads its lane's point-source values once:
  // a register operand lets every cell add them branch-free, as the
  // kernel parameter of a one-lane launch does
  float drive[2] = {0.f, 0.f};
  if (MULTI && p.pc >= 0) {
    drive[0] = p.lane_drive[2 * lane];
    drive[1] = p.lane_drive[2 * lane + 1];
  }

  copy_table(p.fe, tid, jw, wy, kw, wz, rt_e);
  copy_table(p.fh, tid, jw, wy, kw, wz, rt_h);
  if (EDGE) {
    for (int f = 0; f < 2; ++f) {
      for (int a = 0; a < 3; ++a) {
        const float* src = (f == 0 ? p.fe : p.fh).prof[a];
        float* dst = prof + prof_offset(p, f, a);
        for (int t = tid; t < 6 * p.m[a]; t += NT) dst[t] = src[t];
      }
    }
  }
  __syncthreads();

  // generation 0 of plane x (< lim) into the rings: H for the window,
  // E, the E coefficients and J for the columns that compute E, the
  // staged record rows; one commit group a plane. The fields: float by
  // cp.async; bf16 into the registers hw, ew, which put_plane widens into
  // the rings
  T hw[3], ew[3];
  auto load_plane = [&](int x) {
    if (x >= lim) return;
    const int slot = x & (RING - 1);
    if (inside) {
      const int64_t off = lf + (int64_t)x * pstride + cidx;
      const int s = slot * PLANE + tid;
      // a shard reads each field through its column's place (gcol)
      int64_t hs = vol, es = vol;
      const T* const hp =
          SHARD ? field_at<T>(p, p.H0, p.gH, gc, x, hs) : H0 + off;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        if constexpr (BF) {
          hw[c] = hp[c * hs];
        } else {
          cp_async4(h0r + s + c * NT, hp + c * hs);
        }
      }
      if (in_e1) {
        const T* const ep =
            SHARD ? field_at<T>(p, p.E0, p.gE, gc, x, es) : E0 + off;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          if constexpr (BF) {
            ew[c] = ep[c * es];
          } else {
            cp_async4(e0r + s + c * NT, ep + c * es);
          }
        }
        if (GRID) {
          const int64_t at = (int64_t)x * pstride + cidx;
          float* cs = cr + slot * 2 * PLANE + tid;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const Coef& a = p.fe.a[c];
            const Coef& b = p.fe.b[c];
            if (a.grid) {
              cp_async4(cs + c * NT,
                        SHARD ? grid_at(p, a.grid, p.gco[0][c], gc, x)
                              : a.grid + lane * a.lane + at);
            }
            if (b.grid) {
              cp_async4(cs + (3 + c) * NT,
                        SHARD ? grid_at(p, b.grid, p.gco[1][c], gc, x)
                              : b.grid + lane * b.lane + at);
            }
          }
          if (p.J0) {
            int64_t js = vol;
            const float* const jp =
                SHARD ? field_at<float>(p, p.J0, p.gJ, gc, x, js)
                      : p.J0 + off;
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              cp_async4(j0r + s + c * NT, jp + c * js);
            }
          }
        }
      }
    }
    // staged record rows: this thread's place l of generation g of slot
    // sl of family f
    if (tid < 2 * REC_SLOTS * 2 * REC_ROW &&
        tab.rt[0].nslot + tab.rt[1].nslot > 0) {
      const int l = tid % REC_ROW;
      const int g = (tid / REC_ROW) % 2;
      const int sl = (tid / (2 * REC_ROW)) % REC_SLOTS;
      const int f = tid / (2 * REC_ROW * REC_SLOTS);
      const RecTable& rt = tab.rt[f];
      if (sl < rt.nslot) {
        const int r = rt.srec[sl];
        const bool ynorm = rt.axis[r] == 1;
        const int at = ynorm ? kw + l : jw + l;
        if (l < (ynorm ? wz : wy) && at >= 0 && at < (ynorm ? n3 : n2)) {
          cp_async4(stage + stage_row(f, sl, g, x) + l,
                    p.terms + terms_row<MULTI>(p, g, lane) + rt.off[r] +
                        (int64_t)x * (ynorm ? n3 : n2) + at);
        }
      }
    }
  };
  // bf16: the field words load_plane(x) fetched, widened into the rings
  auto put_plane = [&](int x) {
    if (!BF || x >= lim || !inside) return;
    const int s = (x & (RING - 1)) * PLANE + tid;
#pragma unroll
    for (int c = 0; c < 3; ++c) h0r[s + c * NT] = widen(hw[c]);
    if (in_e1) {
#pragma unroll
      for (int c = 0; c < 3; ++c) e0r[s + c * NT] = widen(ew[c]);
    }
  };
  if (ib > 0 && inside) {  // H of plane ib - 1, read by E1(ib)
    const int64_t off = lf + (int64_t)(ib - 1) * pstride + cidx;
    const int s = ((ib - 1) & (RING - 1)) * PLANE + tid;
    int64_t hs = vol;
    const T* const hp =
        SHARD ? field_at<T>(p, p.H0, p.gH, gc, ib - 1, hs) : H0 + off;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if constexpr (BF) {
        h0r[s + c * NT] = ld(hp + c * hs);
      } else {
        cp_async4(h0r + s + c * NT, hp + c * hs);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < PIPE; ++q) {
    load_plane(ib + q);
    put_plane(ib + q);
    cp_commit();
  }

  for (int t = tid; t < lim - ib; t += NT) {
    tab.xb[0][t] = static_cast<unsigned short>(plane_bits(rt_e, ib + t));
    tab.xb[1][t] = static_cast<unsigned short>(plane_bits(rt_h, ib + t));
  }
  const unsigned cb_e = column_bits(rt_e, p.fe.n_rec, j, k);
  const unsigned cb_h = column_bits(rt_h, p.fh.n_rec, j, k);
  // columns in a y or z slab take the full path on every plane
  const bool col_slab = ((AX & 2) && col.qy >= 0) || ((AX & 4) && col.qz >= 0);

  // generation-1 recursion state of this column: the plane just made
  // (*_new) and the one before (*_old)
  float pe_new[6] = {0.f}, pe_old[6] = {0.f};
  float ph_new[6] = {0.f}, ph_old[6] = {0.f};
  float j_new[3] = {0.f}, j_old[3] = {0.f};
  // the edge kernel's generation-0 psi, loaded one plane ahead: psi_E of
  // plane i + 1 after E1(i), psi_H of plane i after H1(i - 1)
  float pse[6] = {0.f}, psh[6] = {0.f};
  if (EDGE) {
    const Pl pl = plane<SHARD>(p, ib);
    if (in_e1) load_psi<AX, SHARD>(p, p.psE0, p.gpE, lane, col, pl, pse);
    if (in_h1) load_psi<AX, SHARD>(p, p.psH0, p.gpH, lane, col, pl, psh);
  }

  for (int i = ib; i <= x1 + 1; ++i) {
    load_plane(i + PIPE);
    cp_commit();
    cp_wait<PIPE>();
    __syncthreads();
    // generation-0 ring offsets of planes i and i - 1; generation-1 ring
    // offsets: plane i (and i-2) in slot i & 1, plane i-1 in the other
    const int r_i = (i & (RING - 1)) * PLANE;
    const int r_m = ((i - 1) & (RING - 1)) * PLANE;
    const int s_i = (i & 1) * PLANE;
    const int s_m = ((i + 1) & 1) * PLANE;
    const Pl pl_i = plane<SHARD>(p, i);
    const Pl pl_a = plane<SHARD>(p, i - 1);
    const Pl pl_2 = plane<SHARD>(p, i - 2);
    const Src src_i = {stage, cr + 2 * r_i + tid, prof};
    const Src src_m = {stage, cr + 2 * r_m + tid, prof};

    // phase E1(i)
    if (i < lim && in_e1) {
      const int64_t cell = (int64_t)i * pstride + cidx;
      const unsigned bits = cb_e | tab.xb[0][i - ib];
      const bool full = bits != 0u || (col_slab || ((AX & 1) && pl_i.qx >= 0));
      float old[3], jn[3] = {0.f, 0.f, 0.f}, out[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) old[c] = e0r[r_i + c * NT + tid];
      if (GRID && p.J0) {
#pragma unroll
        for (int c = 0; c < 3; ++c) jn[c] = j0r[r_i + c * NT + tid];
      }
      E_CELL(0, p, rt_e, bits, h0r, r_i, r_m, col, pl_i, src_i, lane, cell,
             cell, gc, tid, old, drive, pcol && i == p.pi, pse, jn, pe_new,
             j_new, out, false);
#pragma unroll
      for (int c = 0; c < 3; ++c) e1r[s_i + c * NT + tid] = out[c];
      if (EDGE && i + 1 < lim) {
        load_psi<AX, SHARD>(p, p.psE0, p.gpE, lane, col,
                            plane<SHARD>(p, i + 1), pse);
      }
    }
    __syncthreads();

    // phase H1(i-1): E1 at i-1 and i, H0 at i-1
    const int xa = i - 1;
    if (xa >= ib && xa <= x1 && xa < n1 && in_h1) {
      const int64_t cell = (int64_t)xa * pstride + cidx;
      const unsigned bits = cb_h | tab.xb[1][xa - ib];
      const bool full = bits != 0u || (col_slab || ((AX & 1) && pl_a.qx >= 0));
      float old[3], out[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) old[c] = h0r[r_m + c * NT + tid];
      H_CELL(0, p, rt_h, bits, e1r, s_m, s_i, col, pl_a, src_m, lane, cell,
             cell, gc, tid, old, psh, ph_new, out, false);
#pragma unroll
      for (int c = 0; c < 3; ++c) h1r[s_m + c * NT + tid] = out[c];
      if (EDGE && i <= x1 && i < n1) {
        load_psi<AX, SHARD>(p, p.psH0, p.gpH, lane, col, pl_i, psh);
      }
    }
    __syncthreads();

    // phase E2(i-1): H1 at i-1 and i-2, E1 at i-1; written on [x0, x1)
    if (xa >= x0 && xa <= x1 && xa < n1 && in_e2) {
      const int64_t cell = (int64_t)xa * pstride + cidx;
      // the cell in the shard's own stacks (owned cells only)
      const int64_t lcell =
          SHARD ? (int64_t)(xa - p.lo[0]) * gc.ps + gc.base : cell;
      const bool store = own && xa < x1;
      const unsigned bits = cb_e | tab.xb[0][xa - ib];
      const bool full = bits != 0u || (col_slab || ((AX & 1) && pl_a.qx >= 0));
      float old[3], out[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) old[c] = e1r[s_m + c * NT + tid];
      E_CELL(1, p, rt_e, bits, h1r, s_m, s_i, col, pl_a, src_m, lane, cell,
             lcell, gc, tid, old, drive, pcol && xa == p.pi, pse, j_new, pe_old,
             j_old, out, store);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        e2r[s_m + c * NT + tid] = out[c];
        if (store) st(E2 + lf + c * lvol + lcell, out[c]);
      }
    }
    __syncthreads();

    // phase H2(i-2): E2 at i-2 and i-1, H1 at i-2
    const int x2 = i - 2;
    if (x2 >= x0 && x2 < x1 && own) {
      const int64_t cell = (int64_t)x2 * pstride + cidx;
      const int64_t lcell =
          SHARD ? (int64_t)(x2 - p.lo[0]) * gc.ps + gc.base : cell;
      const unsigned bits = cb_h | tab.xb[1][x2 - ib];
      const bool full = bits != 0u || (col_slab || ((AX & 1) && pl_2.qx >= 0));
      float old[3], out[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) old[c] = h1r[s_i + c * NT + tid];
      H_CELL(1, p, rt_h, bits, e2r, s_i, s_m, col, pl_2, src_i, lane, cell,
             lcell, gc, tid, old, psh, ph_old, out, true);
#pragma unroll
      for (int c = 0; c < 3; ++c) st(H2 + lf + c * lvol + lcell, out[c]);
    }
    // bf16: plane i + PIPE into the rings, after every read of the slots
    // it refills (see load_plane)
    put_plane(i + PIPE);

    // the plane made this iteration is the next iteration's old plane
    if (EDGE) {
#pragma unroll
      for (int q = 0; q < 6; ++q) {
        pe_old[q] = pe_new[q];
        ph_old[q] = ph_new[q];
      }
    }
    if (GRID) {
#pragma unroll
      for (int c = 0; c < 3; ++c) j_old[c] = j_new[c];
    }
  }
  cp_wait<0>();  // the last groups are empty; none stays in flight

#ifdef TB_BLOCK_TIMER
  __syncthreads();
  if (tid == 0) {
    unsigned long long t_end;
    unsigned smid;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_end));
    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
    const long long b = (long long)first_item * p.lanes + blockIdx.x;
    if (b < TIMER_BLOCKS) {
      g_tb_blocks[3 * b] = t_start;
      g_tb_blocks[3 * b + 1] = t_end;
      g_tb_blocks[3 * b + 2] = smid;
    }
  }
#endif
}


// Each kernel runs the items of one plan section, from item `first`:
// AX, GRID and its target blocks an SM are the section's; an item of a
// section whose slabs include z may take the transposed layout.
template <bool MULTI, int AX, bool GRID, int MINB, typename T, bool SHARD>
__global__ void __launch_bounds__(NT, MINB)
    tb_section(const __grid_constant__ Params p, int first) {
#if ZBAND
  if constexpr ((AX & 4) != 0) {
    const int item =
        first + (MULTI ? (int)(blockIdx.x / p.lanes) : (int)blockIdx.x);
    if (p.plan[PLAN_COLS * item + 7]) {
      march<MULTI, AX, GRID, BZ / 2, T, SHARD>(p, first);
      return;
    }
  }
#endif
  march<MULTI, AX, GRID, BZ, T, SHARD>(p, first);
}

// Dynamic shared memory of a block: the generation-0 rings of H and E,
// the generation-1 rings of E1, H1 and E2, the staged record rows; with
// GRID the E coefficients' and J's rings; the CPML profiles.
static int smem_bytes(bool grid, int msum) {
  return (((2 + (grid ? 3 : 0)) * RING + 6) * PLANE + REC_STAGE +
          12 * msum) *
         static_cast<int>(sizeof(float));
}

typedef void (*Kernel)(const Params, int);

// The plan's sections, in launch order (ops/packed_tb.py::SECTIONS): the
// edge kernels (the items whose cells touch a CPML slab: grids, the slab
// of x only, of y only, of z only, several), then the inner kernel (grids,
// none). GRID: the items whose cells read a coefficient grid or Drude J
// (the other items of a call with grids take each grid's background
// value, which Coef.val then holds); they need the larger shared memory
// of the coefficient and J rings, so their builds are for one block an
// SM. The kernels of one slab axis keep less psi state than the general
// one and are built for SINGLE_BLOCKS. Each has a float and a bf16 build.
#define SECTION(AX, GRID, MINB, T)                \
  {                                               \
    tb_section<false, AX, GRID, MINB, T, false>,  \
        tb_section<true, AX, GRID, MINB, T, false>, \
        tb_section<false, AX, GRID, MINB, T, true>  \
  }
#define SECTION_KERNELS(T)                                            \
  {                                                                   \
    SECTION(7, true, EDGE_BLOCKS, T), SECTION(1, false, SINGLE_BLOCKS, T), \
        SECTION(2, false, SINGLE_BLOCKS, T),                          \
        SECTION(4, false, SINGLE_BLOCKS, T),                          \
        SECTION(7, false, EDGE_BLOCKS, T), SECTION(0, true, 1, T),    \
        SECTION(0, false, INNER_BLOCKS, T)                            \
  }
#define VARIANTS 3  // solo, lanes, a shard (one lane)
static const Kernel kKernels[2][SECTIONS][VARIANTS] = {
    SECTION_KERNELS(float), SECTION_KERNELS(bf16_t)};
#define KERNEL(q)                                                       \
  kKernels[(q) / (VARIANTS * SECTIONS)][(q) / VARIANTS % SECTIONS] \
          [(q) % VARIANTS]
static const bool kGrid[SECTIONS] = {true,  false, false, false,
                                     false, true,  false};

// Lets every kernel take the largest shared memory a call may need (at
// most what the card allows a block) and prefer shared memory over L1,
// once.
static int g_smem_most = 0;  // shared memory a block may have (opt-in)

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
  const int want = smem_bytes(true, MAX_SLAB_SUM);
  for (int q = 0; q < 2 * VARIANTS * SECTIONS; ++q) {
    const Kernel k = KERNEL(q);
    cudaFuncAttributes a;
    err = cudaFuncGetAttributes(&a, k);
    if (err != cudaSuccess) return err;
    const int room = most - static_cast<int>(a.sharedSizeBytes);
    err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize,
        want < room ? want : room);
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

extern "C" {

int fdtd_tb_params_size() { return static_cast<int>(sizeof(Params)); }

// The geometry the plan must follow: out = {owned y extent of a tile,
// owned z extent, MAX_PLANES, whether z-band items may take the
// transposed layout (owned 2 BY - 4 along y, BZ / 2 - 4 along z)}.
int fdtd_tb_tile(int* out) {
  out[0] = BY - 2 * HALO;
  out[1] = BZ - 2 * HALO;
  out[2] = MAX_PLANES;
  out[3] = ZBAND;
  return 0;
}

// Per kernel (each section's solo build, its lane-capable one and its
// sharded one; the float builds, then the bf16 ones), four ints:
// registers a thread, local (spill) bytes a thread, resident blocks an SM
// at the call's shared memory (CPML of 8 planes on every axis), static
// shared bytes.
int fdtd_tb_occupancy(int* out) {
  cudaError_t err = set_attributes();
  for (int q = 0; q < 2 * VARIANTS * SECTIONS && err == cudaSuccess; ++q) {
    const Kernel k = KERNEL(q);
    cudaFuncAttributes a;
    err = cudaFuncGetAttributes(&a, k);
    int blocks = 0;
    const int smem = smem_bytes(kGrid[q / VARIANTS % SECTIONS], 24);
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

int fdtd_tb_pass(const Params* p, void* stream) {
  cudaError_t err = set_attributes();
  if (err != cudaSuccess) return static_cast<int>(err);
  long long items = 0;
  for (int q = 0; q < SECTIONS; ++q) {
    if (p->n_item[q] < 0) {
      return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    items += p->n_item[q];
  }
  const int msum = p->m[0] + p->m[1] + p->m[2];
  if (p->lanes < 1 || items * p->lanes > 0x7fffffffLL ||
      msum > MAX_SLAB_SUM || (p->shard && p->lanes != 1)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const dim3 block(BZ, BY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int first = 0;
  for (int q = 0; q < SECTIONS; ++q) {  // in the plan's order
    const int n = p->n_item[q];
    if (n > 0) {
      void* args[] = {const_cast<Params*>(p), &first};
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(n * p->lanes);
      cfg.blockDim = block;
      cfg.dynamicSmemBytes = smem_bytes(kGrid[q], msum);
      cfg.stream = s;
      // every section's kernel but the call's first may overlap the one
      // before it (programmatic dependent launch): the sections write
      // disjoint cells and read only the source buffers; the first waits
      // for all earlier work on the stream, as every later launch on it
      // waits for both
      cudaLaunchAttribute attr;
      attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
      attr.val.programmaticStreamSerializationAllowed = 1;
      cfg.attrs = &attr;
      cfg.numAttrs = OVERLAP && first > 0 ? 1 : 0;
      const int variant = p->shard ? 2 : (p->lanes > 1 ? 1 : 0);
      err = cudaLaunchKernelExC(
          &cfg,
          reinterpret_cast<const void*>(kKernels[p->bf16 ? 1 : 0][q][variant]),
          args);
      if (err == cudaSuccess) err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    first += n;
  }
  return static_cast<int>(cudaSuccess);
}

#ifdef TB_BLOCK_TIMER
// Each block's start and end (%globaltimer, ns) and SM of the last call:
// 3 values a block, edge blocks first; n values at most.
int fdtd_tb_blocks(unsigned long long* out, int n) {
  const int most = 3 * TIMER_BLOCKS;
  return static_cast<int>(cudaMemcpyFromSymbol(
      out, g_tb_blocks, (n < most ? n : most) * sizeof(unsigned long long)));
}
#endif

const char* fdtd_tb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
