// Packed double-single (float32x2) leapfrog half-steps of the 3D Yee
// scheme, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// fdtd3d_tpu/ops/pallas_packed_ds.py::make_packed_ds_step (kernel body
// at pallas_packed_ds.py:429, pallas_call at :936) for unsharded 3D
// float32x2 runs.
//
// What one step computes, on the reference's stacked layout
// E, H = (6, n1, n2, n3) float32, rows [0,3) hi words and [3,6) lo
// words, C order, z innermost, every value the pair hi + lo:
//   E' = ca E + cb (curl_b H + CPML terms + source records - J'),
//   J' = kj J + bj E_hi                          (plain f32, as the
//                                                 reference keeps it)
//   H' = da H - db (curl_f E' + CPML terms + source records)
// with each difference, product and sum an error-free-transform (EFT)
// sequence: the differences are exact (two_diff) and scaled by 1/dx as
// a pair, the slab CPML runs as pair recursions on compact slab stacks
// (psi' = b psi + c d, term = ik d + psi'), each source record's plane
// term is added into the accumulator pair at its plane before the
// coefficient multiply, and ca/cb/da/db are pairs (scalars or grids).
//
// The EFT hazard. A compiler that contracts a*b + c into one FMA, or
// reassociates, breaks two_sum, two_prod and everything built on them.
// Every EFT operation below is therefore written with the explicitly
// rounded intrinsics __fadd_rn/__fsub_rn/__fmul_rn, which nvcc never
// contracts, and the library is also built with --fmad=false. No fast
// math: the lo words may be subnormal and must not be flushed.
// two_prod is Dekker's split product (no fmaf), so the kernel computes
// the same bits as the reference and the plain PyTorch version in every
// case, underflow included.
//
// Design. As in packed_eh.cu: the TPU kernel lags H one x-tile behind E
// in an ordered grid, which CUDA does not have, so a step is two
// launches, fdtd_ds_e_update then fdtd_ds_h_update, one thread per cell
// with z innermost, each updating its family in place (a cell's new
// value reads its own old value and the OTHER family's neighbours only).
// The step is bound by memory bytes: a launch reads the other family's
// 6 words and reads and writes its own 6, 72 B/cell a launch, about
// 400 EFT flops per cell a launch, below the H100's 20 flops per byte.
// Records come as a table in the parameter block (component, normal
// axis, plane, offset into the stacked plane terms); the point source
// is a record carrying its own pair.
//
// Offsets are 64-bit. Every entry returns cudaGetLastError() so the
// caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_REC 16  // mirrors fdtd3d_torch/ops/packed_ds.py

struct Pair {
  const float* hi;  // (n1, n2, n3) grids, or nullptr for the scalar pair
  const float* lo;
  float vh, vl;
};

struct Coef {
  const float* grid;  // (n1, n2, n3) or nullptr
  float val;
};

struct Rec {
  long long off;  // offset of the plane term in `terms` (TFSF records)
  int comp;       // component index within the family
  int axis;       // normal axis of the plane
  int plane;      // index of the plane along `axis`
  int point;      // 1: the point source at (plane, pj, pk), pair (vh, vl)
  int pj, pk;
  float vh, vl;
};

struct Params {
  float* F;              // family being updated, (6, n1, n2, n3)
  const float* S;        // curl source family, (6, n1, n2, n3)
  float* J;              // Drude J (3, n1, n2, n3) or nullptr (E only)
  float* psi[3];         // per axis a: (4, n with dim a = 2 m[a]) or null
  const float* prof[3];  // per axis a: (6, 2 m[a]) b, c, ik hi then lo
  const float* terms;    // (2, total) record plane terms, hi then lo
  long long total;
  int m[3];              // slab planes per side, 0 = no CPML on the axis
  Pair a[3];             // ca (E) / da (H)
  Pair b[3];             // cb (E) / db (H)
  Coef kj[3];            // Drude, E only
  Coef bj[3];
  Rec rec[MAX_REC];
  int n_rec;
  int n1, n2, n3;
  float iv_h, iv_l;      // 1/dx as a pair
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
  float ah, al, bh, bl;
  split(a, ah, al);
  split(b, bh, bl);
  e = __fadd_rn(__fadd_rn(__fadd_rn(__fsub_rn(__fmul_rn(ah, bh), p),
                                    __fmul_rn(ah, bl)),
                          __fmul_rn(al, bh)),
                __fmul_rn(al, bl));
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
// the kernel
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

__device__ __forceinline__ void pair_coef(const Pair& c, int64_t cell,
                                          float& h, float& l) {
  if (c.hi) {
    h = c.hi[cell];
    l = c.lo[cell];
  } else {
    h = c.vh;
    l = c.vl;
  }
}

__device__ __forceinline__ float coef(const Coef& c, int64_t cell) {
  return c.grid ? c.grid[cell] : c.val;
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

// Index of cell (i, j, k) inside the plane term of a record whose
// normal is `axis` (C order over the two other axes).
__device__ __forceinline__ int64_t plane_index(int axis, int i, int j,
                                               int k, int64_t n2,
                                               int64_t n3) {
  if (axis == 0) return j * n3 + k;
  if (axis == 1) return i * n3 + k;
  return i * n2 + j;
}

// One family update. BACKWARD = true: E from backward differences of H
// (with Drude J and PEC walls); false: H from forward differences of E.
template <bool BACKWARD>
__global__ void __launch_bounds__(128) family_update(const Params p) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y;
  const int i = blockIdx.z;
  if (k >= p.n3) return;
  const int64_t n1 = p.n1, n2 = p.n2, n3 = p.n3;
  const int64_t vol = n1 * n2 * n3;
  const int64_t cell = (i * n2 + j) * n3 + k;
  const int64_t stride[3] = {n2 * n3, n3, 1};
  const int idx[3] = {i, j, k};
  const int n[3] = {p.n1, p.n2, p.n3};

#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float ah = 0.f, al = 0.f;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int a = term_axis(c, t);
      const float* sh = p.S + term_comp(c, t) * vol + cell;
      const float* sl = sh + 3 * vol;
      float th, tl;
      if (BACKWARD) {
        const bool in = idx[a] > 0;
        const float gh = in ? sh[-stride[a]] : 0.f;
        const float gl = in ? sl[-stride[a]] : 0.f;
        ds_diff(sh[0], sl[0], gh, gl, p.iv_h, p.iv_l, th, tl);
      } else {
        const bool in = idx[a] < n[a] - 1;
        const float gh = in ? sh[stride[a]] : 0.f;
        const float gl = in ? sl[stride[a]] : 0.f;
        ds_diff(gh, gl, sh[0], sl[0], p.iv_h, p.iv_l, th, tl);
      }
      const int m = p.m[a];
      if (m > 0) {
        const int ia = idx[a];
        const int q = ia < m ? ia : (ia >= n[a] - m ? ia - (n[a] - 2 * m)
                                                    : -1);
        if (q >= 0) {
          const int row = c < a ? c : c - 1;
          const int64_t m2 = 2 * m;
          const int64_t oh = psi_offset(a, row, q, i, j, k, n1, n2, n3, m2);
          const int64_t ol =
              psi_offset(a, row + 2, q, i, j, k, n1, n2, n3, m2);
          const float* pr = p.prof[a];
          float x1h, x1l, x2h, x2l, pnh, pnl, yh, yl;
          mul_ff(pr[q], pr[3 * m2 + q], p.psi[a][oh], p.psi[a][ol], x1h,
                 x1l);
          mul_ff(pr[m2 + q], pr[4 * m2 + q], th, tl, x2h, x2l);
          add_ff(x1h, x1l, x2h, x2l, pnh, pnl);
          p.psi[a][oh] = pnh;
          p.psi[a][ol] = pnl;
          mul_ff(pr[2 * m2 + q], pr[5 * m2 + q], th, tl, yh, yl);
          add_ff(yh, yl, pnh, pnl, th, tl);
        }
      }
      if (t == 1) {
        th = -th;
        tl = -tl;
      }
      if (t == 0) {
        ah = th;
        al = tl;
      } else {
        add_ff(ah, al, th, tl, ah, al);
      }
    }
    // source records, in table order, at their planes
    for (int r = 0; r < p.n_rec; ++r) {
      const Rec& rc = p.rec[r];
      if (rc.comp != c || idx[rc.axis] != rc.plane) continue;
      if (rc.point) {
        if (j == rc.pj && k == rc.pk) add_ff(ah, al, rc.vh, rc.vl, ah, al);
      } else {
        const float* tp =
            p.terms + rc.off + plane_index(rc.axis, i, j, k, n2, n3);
        add_ff(ah, al, tp[0], tp[p.total], ah, al);
      }
    }
    float* fh = p.F + c * vol + cell;
    float* fl = fh + 3 * vol;
    const float oh = *fh, ol = *fl;
    float ch, cl, bh, bl, t1h, t1l, t2h, t2l, vh, vl;
    pair_coef(p.a[c], cell, ch, cl);
    pair_coef(p.b[c], cell, bh, bl);
    if (BACKWARD) {
      if (p.J) {
        float* jp = p.J + c * vol + cell;
        const float jn = __fadd_rn(__fmul_rn(coef(p.kj[c], cell), *jp),
                                   __fmul_rn(coef(p.bj[c], cell), oh));
        *jp = jn;
        add_f(ah, al, -jn, ah, al);
      }
      mul_ff(oh, ol, ch, cl, t1h, t1l);
      mul_ff(ah, al, bh, bl, t2h, t2l);
      add_ff(t1h, t1l, t2h, t2l, vh, vl);
      // PEC walls: tangential E vanishes on the walls of the two axes
      // other than its own (an exact 0/1 factor, as the reference's)
#pragma unroll
      for (int w = 0; w < 3; ++w) {
        if (w != c && (idx[w] == 0 || idx[w] == n[w] - 1)) {
          vh = __fmul_rn(vh, 0.f);
          vl = __fmul_rn(vl, 0.f);
        }
      }
    } else {
      mul_ff(oh, ol, ch, cl, t1h, t1l);
      mul_ff(ah, al, bh, bl, t2h, t2l);
      add_ff(t1h, t1l, -t2h, -t2l, vh, vl);
    }
    *fh = vh;
    *fl = vl;
  }
}

static int launch(const Params* p, void* stream, bool backward) {
  const dim3 block(128);
  const dim3 grid((p->n3 + 127) / 128, p->n2, p->n1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (backward) {
    family_update<true><<<grid, block, 0, s>>>(*p);
  } else {
    family_update<false><<<grid, block, 0, s>>>(*p);
  }
  return static_cast<int>(cudaGetLastError());
}

// The EFT probe: the kernel's own two_sum and two_prod on n pairs.
__global__ void eft_probe(const float* a, const float* b, float* s,
                          float* e, float* pr, float* pe, int n) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= n) return;
  two_sum(a[x], b[x], s[x], e[x]);
  two_prod(a[x], b[x], pr[x], pe[x]);
}

extern "C" {

int fdtd_ds_params_size() { return static_cast<int>(sizeof(Params)); }

int fdtd_ds_e_update(const Params* p, void* stream) {
  return launch(p, stream, true);
}

int fdtd_ds_h_update(const Params* p, void* stream) {
  return launch(p, stream, false);
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
