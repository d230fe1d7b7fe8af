// The per-round re-fit of an ellipsoid stack before a chained uniform
// round, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: it is the XLA program of the JAX package's
// dynesty_tpu/internal/kernels.py:206 make_ellipsoid_refit, which the
// jitted round runs before every chained unif round
// (dynesty_tpu/internal/samplers.py:495-505), inside the one device
// program.  Here it is two kernels inside the round's captured prologue
// (internal/fused.py), writing straight into the wave's buffers; the
// plain version (ops/ellipsoid_refit.py, ellipsoid_refit_plain) is the
// CPU path and the kernels' oracle.
//
// Two kernels, launched back to back on the caller's stream:
//   refit_assign, a thread per (live point, slot): a point's slots lie on
//     `group` neighbouring lanes (the power of 2 >= m, at most 32; lane g
//     takes the slots g, g + group, ... in turn), each lane the quadratic
//     form (x - c)^T A (x - c) under the dispatch's fit (inf on a slot off
//     the mask), the block's points and the slots' matrices and centres
//     copied into shared memory in one trip (cp.async; tiles of slots
//     where they do not fit); the lanes' best slots meet by shuffles under
//     torch.argmin's order (a NaN first, then the smallest form, then the
//     first slot).  A block also writes its points' d coordinates packed
//     (`rows`, which refit_fit reads) and flags a point with a coordinate
//     that is not finite (the plain version's one-hot product makes every
//     mean NaN then: 0 * inf).
//   refit_fit, a block a slot: its members listed in the points' order (a
//     thread loads the slots of a run of up to LIST_RUN consecutive points
//     at once; one block scan ranks the matches; one slot's members are
//     every point) and their packed rows copied into shared memory,
//     coordinate-major, all at once (cp.async); the count, the mean and
//     the MLE covariance of the centred members (the lower triangle), the
//     trace floor 1e-10 * max(tr / d, 1e-30) on the diagonal and the
//     Cholesky factor on one warp, its inverse, am = Linv^T Linv (at d 2
//     and 3 the three on one thread, in registers), each member's
//     distance under am and their maximum, all from shared memory; then
//     f = sqrt(max(fmax, 1e-30) / (1 - 1e-3)) * expand and the slot's
//     centre, axes L f, matrix am / f^2 and log-volume
//     sum log|L_ii| + d log f + the d-ball's prefactor.  A slot off the
//     mask, with fewer than d + 1 members, a live point not finite, a
//     pivot that is not positive or a factor not finite copies the
//     dispatch's fit.
//
// The orders of every sum are fixed, and each result is the same bits
// whatever the grid: no atomics, and each operation written so that nvcc
// contracts nothing on its own (the R<T> helpers; an fma where a product
// feeds a sum, as the expressions `acc += a * b` compiled):
//   - a member sum of E elements (the mean, E = d; the covariance, E =
//     d (d + 1) / 2) runs in chunks of BLOCK elements; a chunk of C
//     elements has S = BLOCK / C stripes an element, stripe s summing the
//     members k = s, s + S, ... (listed in the points' order) in rising
//     k, and one thread an element then adds the S stripes in order; S
//     is fixed by BLOCK, never by the grid;
//   - a form is d_l = x_l - c_l; t_r = sum_l A_rl d_l; sq = sum_r d_r t_r,
//     left to right (several rows' t_r run side by side, each in its own
//     order);
//   - the factor is right-looking: each entry's updates L_rc -= L_rk L_ck
//     in rising k, a column's entries over its pivot's square root; the
//     inverse is forward substitution a column at a time, each entry's
//     sum in rising k; each entry of am sums over rising k; the
//     log-volume adds the log|L_ii| in rising i;
//   - the maximum of the distances (from 0, NaN wins) is exact in any
//     order.
// So two launches on the same inputs give the same bits, a run on the
// card reproduces itself and resumes bit for bit, and a change of grid,
// block or staging moves no bit.  The orders are not cuBLAS's and
// cuSOLVER's, which the eager refit goes through, so the results agree
// with the plain version to rounding (held at 1e-10 relative in float64),
// not bit for bit.
//
// Shared memory (the layouts below; ops/ellipsoid_refit.py mirrors them):
// refit_fit stages up to `cap` members' coordinates (cap = n where they
// fit in SMEM_BUDGET, 224 kB: 3000 points of 3 float64 coordinates take
// 72 kB; rows `pitch` apart, odd, so that stripes of several coordinates
// hit different banks), and the slot's matrices and mean where they fit
// in MATS_MAX (d <= 52 in float64), else in the wrapper's global `work`
// row.  A slot of more than cap members (past the ceiling, e.g. 16384
// members of one slot in 3 dimensions) is summed in stages of cap members
// of rising k, listed again for each stage, every stripe carrying its sum
// across stages, so the orders hold.  refit_assign stages the block's
// points where they fit in POINTS_MAX and the slots' arrays in tiles that
// fit in what is left, carrying each lane's best slot across tiles (and
// reads both in place where not one slot fits).  Where each part lives
// is a template argument, not a pointer chosen at run time: a load
// through a pointer that may be either memory is a generic load, slower
// than a shared one and never moved past a store.
//
// What bounds it on this card: latency, not bytes or operations.  At the
// eggbox's (1000 points, 32 slots, d 2) the inputs are ~24 kB (~7 ns at
// 3.35 TB/s) and at the heavy drive's (3000, one slot, d 3) ~72 kB; the
// work is a few hundred thousand flops.  Each kernel is a launch
// (~0.8 us) and a chain of dependent steps, each trip to device memory
// ~1,000 SM cycles.  So refit_assign spreads (point, slot) pairs over the
// grid with one trip to stage its block's data; refit_fit makes one trip
// to list and copy its members (one more a stage past the ceiling), and
// everything after it reads shared memory, with independent chains side
// by side (four rows of a form, a lane's entries of the factor's update,
// the logs) and the factor on one warp (__syncwarp, not block barriers).
// What is left is the slot's serial chains (the stripe sums, the d
// pivots' square roots and divisions, the inverse's divisions) and, for
// a slot of thousands of members, one SM's bandwidth from L2: a stack of
// few slots leaves most SMs idle in refit_fit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef long long i64;

namespace {

const int BLOCK = 256;
const int WARPS = BLOCK / 32;
const unsigned FULL = 0xffffffffu;
// the pointer tables' lengths, and the entries that may be null: expand,
// and work where the slot's matrices fit in shared memory
const int N_ASSIGN = 7, N_FIT = 17, P_EXPAND = 7, P_WORK = 9;
// the slots of consecutive points a thread of refit_fit loads at once
const int LIST_RUN = 16;
// the factor's trailing entries a lane updates at once
const int UPD = 4;
// the dynamic shared memory a block takes at most (of the 227 kB a block
// can opt into on an H100), and the parts that go there only up to a size
const i64 SMEM_BUDGET = 224 * 1024;
const i64 MATS_MAX = 64 * 1024;
const i64 POINTS_MAX = 64 * 1024;

// refit_assign's operands, in the order of ops/ellipsoid_refit.py's table
struct AssignArgs {
  const void* u;      // the live points, rows of ldu values, d read
  const void* ctrs0;  // (m, d) the dispatch's fit
  const void* ams0;   // (m, d, d)
  const bool* mask;   // (m,)
  i64* idx;           // (n,) each point's slot
  int* nonfinite;     // (blocks,) a block's points: one coordinate not finite
  void* rows;         // (n, d) the points' d coordinates, packed
};

// refit_fit's operands, in the order of ops/ellipsoid_refit.py's table
struct FitArgs {
  const void* rows;      // (n, d) refit_assign's packed points
  const i64* idx;        // (n,) refit_assign's slots
  const void* ctrs0;     // (m, d) the dispatch's fit
  const void* axes0;     // (m, d, d)
  const void* ams0;      // (m, d, d)
  const void* logvols0;  // (m,)
  const bool* mask;      // (m,)
  const void* expand;    // 0-d, or null (1)
  const void* pref;      // 0-d: the d-ball's log-volume prefactor
  void* work;            // (m, 3 d^2 + d) scratch: L, Linv, am, mean; null
                         // where they fit in shared memory
  void* ctrs;            // (m, d) out: the wave's buffers
  void* axes;            // (m, d, d) out
  void* ams;             // (m, d, d) out
  void* logvols;         // (m,) out
  bool* mask_out;        // (m,) out
  bool* keep;            // (m,) scratch: the slot re-fitted (mask & ok)
  const int* nonfinite;  // (blocks,) refit_assign's flags
};

// refit_assign's grid and shared memory (ops/ellipsoid_refit.py,
// assign_layout, mirrors it)
struct AssignLayout {
  int group;          // lanes a point
  int points;         // points a block
  int blocks;
  int tile;    // slots staged at a time (ams, ctrs; 0 with one slot)
  int staged;  // the block's points and a tile fit: else all read in place
  int bytes;   // dynamic shared memory
};

AssignLayout assign_layout(int n, int m, int d, int fsize) {
  AssignLayout l;
  l.group = 1;
  while (l.group < m && l.group < 32) l.group <<= 1;
  l.points = BLOCK / l.group;
  l.blocks = (n + l.points - 1) / l.points;
  const i64 pts = (i64)l.points * d * fsize;
  const i64 slot = ((i64)d * d + d) * fsize;
  const i64 tile = (SMEM_BUDGET - pts) / slot;
  l.tile = l.staged = l.bytes = 0;
  if (pts > POINTS_MAX || (m > 1 && tile < 1)) return l;
  if (m > 1) l.tile = (int)(tile < m ? tile : m);  // one slot: no form
  l.staged = 1;
  l.bytes = (int)(pts + l.tile * slot);
  return l;
}

// refit_fit's shared memory (ops/ellipsoid_refit.py, fit_layout, mirrors
// it): BLOCK partials, the matrices and mean where they fit, then cap
// members' coordinates, each coordinate's row pitch (odd) apart
struct FitLayout {
  int cap;          // members staged at a time (n: all of any slot's)
  int pitch;        // cap, or cap + 1 where cap is even
  int shared_mats;  // L, Linv, am and the mean in shared memory
  int bytes;        // dynamic shared memory
};

FitLayout fit_layout(int n, int d, int fsize) {
  FitLayout l;
  const i64 mats = (3 * (i64)d * d + d) * fsize;
  l.shared_mats = mats <= MATS_MAX;
  const i64 fixed = (i64)BLOCK * fsize + (l.shared_mats ? mats : 0);
  const i64 member = (i64)d * fsize, room = SMEM_BUDGET - fixed;
  i64 cap = room / member < n ? room / member : n;
  if ((cap | 1) * member > room) --cap;  // an even cap at the budget
  l.cap = (int)cap;
  l.pitch = (int)(cap | 1);
  l.bytes = (int)(fixed + l.pitch * member);
  return l;
}

// each operation rounded once: nvcc contracts none of these into an fma
// of its own, so every product meets its sum where written
template <typename T>
struct R;
template <>
struct R<double> {
  static __device__ __forceinline__ double add(double a, double b) {
    return __dadd_rn(a, b);
  }
  static __device__ __forceinline__ double sub(double a, double b) {
    return __dsub_rn(a, b);
  }
  static __device__ __forceinline__ double mul(double a, double b) {
    return __dmul_rn(a, b);
  }
  static __device__ __forceinline__ double fma(double a, double b,
                                               double c) {
    return __fma_rn(a, b, c);
  }
};
template <>
struct R<float> {
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float sub(float a, float b) {
    return __fsub_rn(a, b);
  }
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
  static __device__ __forceinline__ float fma(float a, float b, float c) {
    return __fmaf_rn(a, b, c);
  }
};

template <typename T>
__device__ __forceinline__ bool is_nan(T x) {
  return x != x;
}

// One value copied from device to shared memory without a register
// (cp.async): a thread's copies are all in flight at once, where a load
// and a store each would wait a trip apiece.  copies_done() waits for the
// thread's own; a barrier after it shows them to the block.
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  const unsigned to = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(to),
               "l"(src), "n"(sizeof(T))
               : "memory");
}

__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// torch.argmin's order on (form, slot): a NaN first (the first NaN), then
// the smallest form, then the first slot
template <typename T>
__device__ __forceinline__ bool before(T a, int ja, T b, int jb) {
  if (is_nan(a)) return !is_nan(b) || ja < jb;
  if (is_nan(b)) return false;
  return a < b || (a == b && ja < jb);
}

// the larger, NaN first (exact in any order)
template <typename T>
__device__ __forceinline__ T max_nan(T a, T b) {
  return is_nan(a) ? a : (is_nan(b) || b > a ? b : a);
}

// (x - c)^T A (x - c) with x's coordinates `xs` apart: d_l = x_l - c_l;
// t_r = sum_l A_rl d_l; sq = sum_r d_r t_r, each sum left to right.  At a
// width known only at run time, four rows' sums run side by side.
template <typename T, int D>
__device__ __forceinline__ T quad_form(const T* x, int xs, const T* c,
                                       const T* A, int d_rt) {
  T sq = (T)0;
  if (D) {
#pragma unroll
    for (int r = 0; r < D; ++r) {
      T t = (T)0;
#pragma unroll
      for (int l = 0; l < D; ++l)
        t = R<T>::fma(A[r * D + l], R<T>::sub(x[l * xs], c[l]), t);
      sq = R<T>::fma(R<T>::sub(x[r * xs], c[r]), t, sq);
    }
    return sq;
  }
  const int d = d_rt;
  for (int r0 = 0; r0 < d; r0 += 4) {
    const T* Ar = A + r0 * d;
    const int nr = min(4, d - r0);
    T t[4] = {(T)0, (T)0, (T)0, (T)0};
#pragma unroll 2
    for (int l = 0; l < d; ++l) {
      const T dl = R<T>::sub(x[l * xs], c[l]);
#pragma unroll
      for (int g = 0; g < 4; ++g)
        if (g < nr) t[g] = R<T>::fma(Ar[g * d + l], dl, t[g]);
    }
#pragma unroll
    for (int g = 0; g < 4; ++g)
      if (g < nr)
        sq = R<T>::fma(R<T>::sub(x[(r0 + g) * xs], c[r0 + g]), t[g], sq);
  }
  return sq;
}

// STAGED: the block's points and the slots' arrays in shared memory (the
// layout's `staged`), else read in place; a kernel each, so that every
// load's memory is known where it is compiled
template <typename T, int D, bool STAGED>
__global__ void __launch_bounds__(BLOCK)
    refit_assign_kernel(AssignArgs a, int n, int m, int d_rt, int ldu,
                        AssignLayout lay) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = D ? D : d_rt, dd = d * d;
  const int tid = threadIdx.x, G = lay.group;
  const int g = tid & (G - 1), pl = tid / G;
  const int i0 = blockIdx.x * lay.points, i = i0 + pl;
  const int np = min(lay.points, n - i0);
  const T* u = (const T*)a.u;
  T* rows = (T*)a.rows + (i64)i0 * d;
  T* sx = (T*)smem;
  T* sA = sx + lay.points * d;
  T* sc = sA + (i64)lay.tile * dd;
  const int step = STAGED && m > 1 ? lay.tile : m;

  // the slots j0 <= j < j0 + nt into shared memory, all copies at once
  auto stage = [&](int j0, int nt) {
    const T* A0 = (const T*)a.ams0 + (i64)j0 * dd;
    const T* C0 = (const T*)a.ctrs0 + (i64)j0 * d;
    for (int e = tid; e < nt * dd; e += BLOCK) copy_async(sA + e, A0 + e);
    for (int e = tid; e < nt * d; e += BLOCK) copy_async(sc + e, C0 + e);
  };
  // the block's points and the first tile, in one trip; the points
  // packed into rows, and a coordinate that is not finite flagged (each
  // thread reads back the copies it made)
  if (STAGED && m > 1) stage(0, step);
  bool finite = true;
  for (int e = tid; e < np * d; e += BLOCK) {
    const int p = e / d;
    const T* src = u + (i64)(i0 + p) * ldu + (e - p * d);
    if (STAGED) {
      copy_async(sx + e, src);
    } else {
      const T v = *src;
      finite = finite && isfinite(v);
      rows[e] = v;
    }
  }
  copies_done();
  if (STAGED)
    for (int e = tid; e < np * d; e += BLOCK) {
      const T v = sx[e];
      finite = finite && isfinite(v);
      rows[e] = v;
    }
  const int any = __syncthreads_or(!finite);
  if (tid == 0) a.nonfinite[blockIdx.x] = any;
  if (m == 1) {
    if (i < n) a.idx[i] = 0;
    return;
  }

  // the lane's slots, tile by tile in rising order: the first best
  const T* x = STAGED ? sx + pl * d : u + (i64)min(i, n - 1) * ldu;
  T best = (T)INFINITY;
  int bj = 0x7fffffff;
  for (int j0 = 0; j0 < m; j0 += step) {
    const int nt = min(step, m - j0);
    if (STAGED && j0 > 0) {
      __syncthreads();  // the last tile's forms are done
      stage(j0, nt);
      copies_done();
      __syncthreads();
    }
    const T* A0 = STAGED ? sA : (const T*)a.ams0 + (i64)j0 * dd;
    const T* C0 = STAGED ? sc : (const T*)a.ctrs0 + (i64)j0 * d;
    for (int jt = g; jt < nt; jt += G) {
      const T sq = a.mask[j0 + jt] ? quad_form<T, D>(x, 1, C0 + jt * d,
                                                     A0 + (i64)jt * dd, d)
                                   : (T)INFINITY;
      if (before(sq, j0 + jt, best, bj)) {
        best = sq;
        bj = j0 + jt;
      }
    }
  }
  // the point's lanes meet: the first best of all its slots
  for (int o = G >> 1; o > 0; o >>= 1) {
    const T ob = __shfl_xor_sync(FULL, best, o);
    const int oj = __shfl_xor_sync(FULL, bj, o);
    if (before(ob, oj, best, bj)) {
      best = ob;
      bj = oj;
    }
  }
  if (g == 0 && i < n) a.idx[i] = bj;
}

// (r, c), c <= r, of the e-th entry of a lower triangle taken row by row
__device__ __forceinline__ void lower_entry(int e, int& r, int& c) {
  r = 0;
  while ((r + 1) * (r + 2) / 2 <= e) ++r;
  c = e - r * (r + 1) / 2;
}

// Slot j's members in the points' order: copies the packed rows of those
// ranked k0 <= k < k0 + cap into xs (coordinate r of member k at
// xs[r * pitch + k - k0]) and returns the slot's member count.  A trip:
// each thread loads the slots of a run of consecutive points at once, one
// block scan ranks the matches (a barrier), and each thread copies its
// members' rows, all at once; with one slot every point is a member, in
// order.  No barrier after the last trip: the caller's.
template <typename T, int D>
__device__ int list_members(const FitArgs& a, int j, int n, int m, int d_rt,
                            int k0, int cap, int pitch, T* xs,
                            int (*wsum)[WARPS]) {
  const int d = D ? D : d_rt;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* __restrict__ rows = (const T*)a.rows;
  if (m == 1) {
    const int nk = min(cap, n - k0);
    for (int e = tid; e < nk * d; e += BLOCK) {
      const int k = e / d;
      copy_async(xs + (i64)(e - k * d) * pitch + k, rows + (i64)k0 * d + e);
    }
    copies_done();
    return n;
  }
  const int run = min(LIST_RUN, (n + BLOCK - 1) / BLOCK);
  int total = 0;
  for (int base = 0, par = 0; base < n; base += BLOCK * run, par ^= 1) {
    const int i0 = base + tid * run;
    i64 s[LIST_RUN];
#pragma unroll
    for (int q = 0; q < LIST_RUN; ++q)
      s[q] = q < run && i0 + q < n ? a.idx[i0 + q] : -1;
    unsigned bits = 0;
#pragma unroll
    for (int q = 0; q < LIST_RUN; ++q) bits |= (unsigned)(s[q] == j) << q;
    const int c = __popc(bits);
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += y;
    }
    // two sets of warp totals: a trip's are read before the next trip's
    // barrier, so the trip after it may write them again
    if (lane == 31) wsum[par][warp] = incl;
    __syncthreads();
    int k = total + incl - c;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int sw = wsum[par][w];
      if (w < warp) k += sw;
      total += sw;
    }
#pragma unroll
    for (int q = 0; q < LIST_RUN; ++q) {
      if (bits >> q & 1u) {
        if (k >= k0 && k < k0 + cap) {
          const T* x = rows + (i64)(i0 + q) * d;
          T* o = xs + (k - k0);
#pragma unroll
          for (int r = 0; r < d; ++r) copy_async(o + (i64)r * pitch, x + r);
        }
        ++k;
      }
    }
  }
  copies_done();
  return total;
}

// The slot's sums over its cnt members of E elements, each over safe, in
// the fixed order (the header): chunks of BLOCK elements; in a chunk of
// C, S = BLOCK / C stripes an element, thread t element e0 + t / S and
// the members k = t mod S, + S, ... rising; then one thread an element
// adds its S stripes in order.  COV false: element e is coordinate e (the
// mean, into out[e]); true: lower entry e of the centred members' outer
// product (into out[r * d + c]).  Past the ceiling (cnt > cap) each
// chunk's members are staged again, cap at a time, each stripe carrying
// its sum.  Ends with a barrier.
template <typename T, int D, bool COV>
__device__ void member_sums(const FitArgs& a, int j, int n, int m, int d_rt,
                            int cnt, int cap, int pitch, T* xs,
                            int (*wsum)[WARPS], T safe, const T* mean,
                            T* out, T* part) {
  const int d = D ? D : d_rt;
  const int t = threadIdx.x;
  const int E = COV ? d * (d + 1) / 2 : d;
  for (int e0 = 0; e0 < E; e0 += BLOCK) {
    const int C = min(E - e0, BLOCK), S = BLOCK / C;
    const bool act = t < C * S;
    const int s = t % S;
    int r = e0 + t / S, c = r;
    if (COV && act) lower_entry(r, r, c);
    const T mr = COV && act ? mean[r] : (T)0;
    const T mc = COV && act ? mean[c] : (T)0;
    const T* xr = xs + (i64)r * pitch;
    const T* xc = xs + (i64)c * pitch;
    T acc = (T)0;
    for (int k0 = 0; k0 < cnt; k0 += cap) {
      if (cnt > cap) {
        __syncthreads();  // the last stage is read
        list_members<T, D>(a, j, n, m, d, k0, cap, pitch, xs, wsum);
        __syncthreads();
      }
      if (act) {
        const int k1 = min(cnt, k0 + cap);
#pragma unroll 4
        for (int k = k0 + ((s - k0 % S) % S + S) % S; k < k1; k += S)
          acc = COV ? R<T>::fma(R<T>::sub(xr[k - k0], mr),
                                R<T>::sub(xc[k - k0], mc), acc)
                    : R<T>::add(acc, xr[k - k0]);
      }
    }
    if (act) part[t] = acc;
    __syncthreads();
    if (t < C) {
      T sum = (T)0;
#pragma unroll 4
      for (int q = 0; q < S; ++q) sum = R<T>::add(sum, part[t * S + q]);
      int r2 = e0 + t, c2 = r2;
      if (COV) lower_entry(r2, r2, c2);
      out[COV ? r2 * d + c2 : r2] = sum / safe;
    }
    __syncthreads();
  }
}

// The conditioning floor 1e-10 * max(tr / d, 1e-30) on the diagonal of
// the covariance held at L(r, r).
template <typename T, typename Diag>
__device__ __forceinline__ void trace_floor(int d, Diag L) {
  T tr = (T)0;
#pragma unroll
  for (int r = 0; r < d; ++r) tr = R<T>::add(tr, L(r, r));
  tr = tr / (T)d;
  const T fl =
      R<T>::mul((T)1e-10, is_nan(tr) || tr > (T)1e-30 ? tr : (T)1e-30);
#pragma unroll
  for (int r = 0; r < d; ++r) L(r, r) = R<T>::add(L(r, r), fl);
}

// At d 2 and 3, one thread takes the floor, the factor, its inverse and
// am in registers, each in the order of the warp's and the block's steps
// below (no barrier between them): writes the factor to L and am to Am,
// and returns whether the slot keeps its fit (every pivot positive, the
// factor finite).
template <typename T, int D>
__device__ bool small_factor(T* L, T* Am) {
  T l[D][D], x[D][D];
#pragma unroll
  for (int r = 0; r < D; ++r)
#pragma unroll
    for (int c = 0; c <= r; ++c) l[r][c] = L[r * D + c];
  trace_floor<T>(D, [&](int r, int c) -> T& { return l[r][c]; });
  bool bad = false, finite = true;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const T p = l[k][k];
    bad = bad || !(p > (T)0);
    l[k][k] = sqrt(p);
#pragma unroll
    for (int r = k + 1; r < D; ++r) l[r][k] = l[r][k] / l[k][k];
#pragma unroll
    for (int r = k + 1; r < D; ++r)
#pragma unroll
      for (int c = k + 1; c <= r; ++c)
        l[r][c] = R<T>::fma(-l[r][k], l[c][k], l[r][c]);
  }
#pragma unroll
  for (int r = 0; r < D; ++r)
#pragma unroll
    for (int c = 0; c <= r; ++c) {
      finite = finite && isfinite(l[r][c]);
      L[r * D + c] = l[r][c];
    }
#pragma unroll
  for (int c = 0; c < D; ++c) {
    x[c][c] = (T)1 / l[c][c];
#pragma unroll
    for (int r = c + 1; r < D; ++r) {
      T s = (T)0;
#pragma unroll
      for (int k = c; k < r; ++k) s = R<T>::fma(l[r][k], x[k][c], s);
      x[r][c] = R<T>::sub((T)0, s) / l[r][r];
    }
  }
#pragma unroll
  for (int r = 0; r < D; ++r)
#pragma unroll
    for (int c = 0; c < D; ++c) {
      T s = (T)0;
#pragma unroll
      for (int k = r > c ? r : c; k < D; ++k)
        s = R<T>::fma(x[k][r], x[k][c], s);
      Am[r * D + c] = s;
    }
  return !bad && finite;
}

// The Cholesky factor in place on L's lower triangle, on one warp:
// column k's pivot's square root (every lane takes it), its entries below
// over it (lane l the rows l, l + 32, ...), then the trailing update,
// UPD entries a lane at once (their loads before their stores), each
// entry's chain in rising k.  Returns whether a pivot was not positive
// (NaN included).
template <typename T>
__device__ bool cholesky_warp(T* L, int d) {
  const int lane = threadIdx.x & 31;
  bool bad = false;
  for (int k = 0; k < d; ++k) {
    const T p = L[k * d + k];
    const T lkk = sqrt(p);  // every lane: the same bits
    bad = bad || !(p > (T)0);
    __syncwarp();  // every lane has read the pivot
    if (lane == 0) L[k * d + k] = lkk;
    for (int r = k + 1 + lane; r < d; r += 32)
      L[r * d + k] = L[r * d + k] / lkk;
    __syncwarp();
    // entry e of the trailing triangle: row k + 1 + r, column k + 1 + c
    const int w = d - 1 - k, ne = w * (w + 1) / 2;
    for (int e0 = lane * UPD; e0 < ne; e0 += 32 * UPD) {
      int r, c;
      lower_entry(e0, r, c);
      int at[UPD];
      T lrk[UPD], lck[UPD], lrc[UPD];
#pragma unroll
      for (int q = 0; q < UPD; ++q) {
        at[q] = e0 + q < ne ? (k + 1 + r) * d + k + 1 + c : -1;
        if (at[q] >= 0) {
          lrk[q] = L[(k + 1 + r) * d + k];
          lck[q] = L[(k + 1 + c) * d + k];
          lrc[q] = L[at[q]];
        }
        if (++c > r) {
          ++r;
          c = 0;
        }
      }
#pragma unroll
      for (int q = 0; q < UPD; ++q)
        if (at[q] >= 0) L[at[q]] = R<T>::fma(-lrk[q], lck[q], lrc[q]);
    }
    __syncwarp();
  }
  return bad;
}

// SM: the slot's matrices and mean in shared memory (the layout's
// `shared_mats`), else in the work row; a kernel each, so that every
// load's memory is known where it is compiled
template <typename T, int D, bool SM>
__global__ void __launch_bounds__(BLOCK)
    refit_fit_kernel(FitArgs a, int n, int m, int d_rt, int nflags,
                     FitLayout lay) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int wsum[2][WARPS];
  __shared__ int skeep;
  __shared__ T sf, slogvol;
  const int d = D ? D : d_rt, dd = d * d;
  const int j = blockIdx.x, tid = threadIdx.x, lane = tid & 31,
            warp = tid >> 5;
  const int cap = lay.cap, pitch = lay.pitch;
  T* part = (T*)smem;
  T* W = SM ? part + BLOCK : (T*)a.work + (i64)j * (3 * dd + d);
  T *L = W, *Li = W + dd, *Am = W + 2 * dd, *mean = W + 3 * dd;
  T* xs = part + BLOCK + (SM ? 3 * dd + d : 0);

  // the slot's flags and scalars and its members, in one trip
  const bool mk = a.mask[j];
  const T ex = a.expand ? *(const T*)a.expand : (T)1;
  const T pref = *(const T*)a.pref;
  int poison = 0;
  for (int b = tid; b < nflags; b += BLOCK) poison |= a.nonfinite[b];
  const int cnt =
      list_members<T, D>(a, j, n, m, d, 0, cap, pitch, xs, wsum);
  poison = __syncthreads_or(poison);
  const bool fit = mk && !poison && cnt >= d + 1;

  if (fit) {
    // the mean, then the centred members' covariance (lower triangle)
    const T safe = cnt > 1 ? (T)cnt : (T)1;
    member_sums<T, D, false>(a, j, n, m, d, cnt, cap, pitch, xs, wsum, safe,
                             mean, mean, part);
    member_sums<T, D, true>(a, j, n, m, d, cnt, cap, pitch, xs, wsum, safe,
                            mean, L, part);
    if constexpr (D > 0) {
      if (tid == 0) skeep = small_factor<T, D>(L, Am);
    } else if (warp == 0) {
      // the conditioning floor on the diagonal, then the factor
      if (lane == 0)
        trace_floor<T>(d, [&](int r, int c) -> T& { return L[r * d + c]; });
      __syncwarp();
      const bool bad = cholesky_warp<T>(L, d);
      bool finite = true;
      for (int p = lane; p < dd; p += 32)
        if (p % d <= p / d && !isfinite(L[p])) finite = false;
      finite = __all_sync(FULL, finite);
      if (lane == 0) skeep = !bad && finite;
    }
    __syncthreads();
  }
  const bool keep = fit && skeep;

  T* ctrs = (T*)a.ctrs + (i64)j * d;
  T* axes = (T*)a.axes + (i64)j * dd;
  T* ams = (T*)a.ams + (i64)j * dd;
  if (tid == 0) {
    a.mask_out[j] = mk;
    a.keep[j] = keep;
  }
  if (!keep) {
    // the slot keeps the dispatch's fit
    const T* c0 = (const T*)a.ctrs0 + (i64)j * d;
    const T* x0 = (const T*)a.axes0 + (i64)j * dd;
    const T* A0 = (const T*)a.ams0 + (i64)j * dd;
    for (int p = tid; p < d; p += BLOCK) ctrs[p] = c0[p];
    for (int p = tid; p < dd; p += BLOCK) {
      axes[p] = x0[p];
      ams[p] = A0[p];
    }
    if (tid == 0) ((T*)a.logvols)[j] = ((const T*)a.logvols0)[j];
    return;
  }

  // the factor's inverse by forward substitution (L X = I), a thread a
  // column: x_c = 1 / L_cc, x_r = (0 - sum_{c<=k<r} L_rk x_k) / L_rr;
  // then am (small_factor took both at d 2 and 3)
  for (int c = tid; c < d && !D; c += BLOCK) {
    for (int r = 0; r < c; ++r) Li[r * d + c] = (T)0;
    Li[c * d + c] = (T)1 / L[c * d + c];
    for (int r = c + 1; r < d; ++r) {
      T s = (T)0;
#pragma unroll 4
      for (int k = c; k < r; ++k)
        s = R<T>::fma(L[r * d + k], Li[k * d + c], s);
      Li[r * d + c] = R<T>::sub((T)0, s) / L[r * d + r];
    }
  }
  __syncthreads();
  // am = Linv^T Linv (cov^-1), over the rows where both columns are set
  for (int p = tid; p < dd && !D; p += BLOCK) {
    const int r = p / d, c = p % d;
    T s = (T)0;
#pragma unroll 4
    for (int k = r > c ? r : c; k < d; ++k)
      s = R<T>::fma(Li[k * d + r], Li[k * d + c], s);
    Am[p] = s;
  }
  __syncthreads();
  // the logs of the factor's diagonal side by side, into Li (read no
  // more); thread 0 adds them in order below
  for (int r = tid; r < d; r += BLOCK) Li[r] = log(fabs(L[r * d + r]));

  // the members' distances under am, their maximum from 0 (NaN wins)
  T fmax = (T)0;
  for (int k0 = 0; k0 < cnt; k0 += cap) {
    if (cnt > cap) {
      __syncthreads();  // the last stage is read
      list_members<T, D>(a, j, n, m, d, k0, cap, pitch, xs, wsum);
      __syncthreads();
    }
    const int nk = min(cap, cnt - k0);
    for (int k = tid; k < nk; k += BLOCK) {
      const T sq = quad_form<T, D>(xs + k, pitch, mean, Am, d);
      if (is_nan(sq) || sq > fmax) fmax = is_nan(fmax) ? fmax : sq;
    }
  }
  for (int o = 16; o > 0; o >>= 1)
    fmax = max_nan(fmax, __shfl_xor_sync(FULL, fmax, o));
  if (lane == 0) part[warp] = fmax;
  __syncthreads();
  if (tid == 0) {
    T fm = part[0];
    for (int w = 1; w < WARPS; ++w) fm = max_nan(fm, part[w]);
    const T cl = is_nan(fm) || fm > (T)1e-30 ? fm : (T)1e-30;
    const T f = R<T>::mul(sqrt(cl / (T)(1.0 - 1e-3)), ex);
    T lv = (T)0;
    for (int r = 0; r < d; ++r) lv = R<T>::add(lv, Li[r]);
    sf = f;
    slogvol = R<T>::add(R<T>::fma((T)d, log(f), lv), pref);
  }
  __syncthreads();
  const T f = sf, f2 = R<T>::mul(f, f);
  for (int p = tid; p < d; p += BLOCK) ctrs[p] = mean[p];
  for (int p = tid; p < dd; p += BLOCK) {
    axes[p] = R<T>::mul(p % d <= p / d ? L[p] : (T)0, f);
    ams[p] = Am[p] / f2;
  }
  if (tid == 0) ((T*)a.logvols)[j] = slogvol;
}

// the opt-in above 48 kB of dynamic shared memory, once a device and
// kernel (the eager warm-up's launch makes it, before any capture)
int allow_smem(const void* fn, int bytes, int* allowed) {
  if (bytes <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (bytes > allowed[dev]) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) {
      cudaGetLastError();  // not left for the next launch's check
      return (int)err;
    }
    allowed[dev] = bytes;
  }
  return 0;
}

template <typename T, int D, bool STAGED>
int assign_d(const AssignArgs& a, int n, int m, int d, int ldu,
             const AssignLayout& lay, cudaStream_t stream) {
  static int allowed[64];
  const int err = allow_smem((const void*)refit_assign_kernel<T, D, STAGED>,
                             lay.bytes, allowed);
  if (err) return err;
  refit_assign_kernel<T, D, STAGED><<<lay.blocks, BLOCK, lay.bytes, stream>>>(
      a, n, m, d, ldu, lay);
  return (int)cudaGetLastError();
}

template <typename T, int D, bool SM>
int fit_d(const FitArgs& a, int n, int m, int d, int nflags,
          const FitLayout& lay, cudaStream_t stream) {
  static int allowed[64];
  const int err = allow_smem((const void*)refit_fit_kernel<T, D, SM>,
                             lay.bytes, allowed);
  if (err) return err;
  refit_fit_kernel<T, D, SM><<<m, BLOCK, lay.bytes, stream>>>(a, n, m, d,
                                                              nflags, lay);
  return (int)cudaGetLastError();
}

bool bad_table(void* const* p, int len, int may_be_null, int also) {
  for (int k = 0; k < len; ++k)
    if (!p[k] && k != may_be_null && k != also) return true;
  return false;
}

template <typename T>
int launch_assign(void* const* p, int n, int m, int d, int ldu,
                  void* stream) {
  if (n < 1 || m < 1 || d < 1 || ldu < d || bad_table(p, N_ASSIGN, -1, -1))
    return (int)cudaErrorInvalidValue;
  AssignArgs a;
  a.u = p[0];
  a.ctrs0 = p[1];
  a.ams0 = p[2];
  a.mask = (const bool*)p[3];
  a.idx = (i64*)p[4];
  a.nonfinite = (int*)p[5];
  a.rows = p[6];
  const AssignLayout lay = assign_layout(n, m, d, sizeof(T));
  cudaStream_t s = (cudaStream_t)stream;
  if (!lay.staged) return assign_d<T, 0, false>(a, n, m, d, ldu, lay, s);
  switch (d) {
    case 2: return assign_d<T, 2, true>(a, n, m, d, ldu, lay, s);
    case 3: return assign_d<T, 3, true>(a, n, m, d, ldu, lay, s);
    default: return assign_d<T, 0, true>(a, n, m, d, ldu, lay, s);
  }
}

template <typename T>
int launch_fit(void* const* p, int n, int m, int d, int ldu, void* stream) {
  if (n < 1 || m < 1 || d < 1 || ldu < d) return (int)cudaErrorInvalidValue;
  const FitLayout lay = fit_layout(n, d, sizeof(T));
  if (lay.cap < 1 ||
      bad_table(p, N_FIT, P_EXPAND, lay.shared_mats ? P_WORK : -1))
    return (int)cudaErrorInvalidValue;
  FitArgs a;
  a.rows = p[0];
  a.idx = (const i64*)p[1];
  a.ctrs0 = p[2];
  a.axes0 = p[3];
  a.ams0 = p[4];
  a.logvols0 = p[5];
  a.mask = (const bool*)p[6];
  a.expand = p[P_EXPAND];
  a.pref = p[8];
  a.work = p[P_WORK];
  a.ctrs = p[10];
  a.axes = p[11];
  a.ams = p[12];
  a.logvols = p[13];
  a.mask_out = (bool*)p[14];
  a.keep = (bool*)p[15];
  a.nonfinite = (const int*)p[16];
  const int nflags = assign_layout(n, m, d, sizeof(T)).blocks;
  cudaStream_t s = (cudaStream_t)stream;
  if (!lay.shared_mats) return fit_d<T, 0, false>(a, n, m, d, nflags, lay, s);
  switch (d) {
    case 2: return fit_d<T, 2, true>(a, n, m, d, nflags, lay, s);
    case 3: return fit_d<T, 3, true>(a, n, m, d, nflags, lay, s);
    default: return fit_d<T, 0, true>(a, n, m, d, nflags, lay, s);
  }
}

}  // namespace

// p: the operands' pointers in the order of AssignArgs / FitArgs
// (ops/ellipsoid_refit.py); n live points, m slots, d dimensions, ldu
// the points' row stride (refit_fit reads refit_assign's packed rows)
#define REFIT_ENTRY(TAG, T)                                                \
  extern "C" int dynesty_refit_assign_##TAG(void* const* p, int n, int m, \
                                            int d, int ldu, void* stream) {\
    return launch_assign<T>(p, n, m, d, ldu, stream);                      \
  }                                                                        \
  extern "C" int dynesty_refit_fit_##TAG(void* const* p, int n, int m,    \
                                         int d, int ldu, void* stream) {   \
    return launch_fit<T>(p, n, m, d, ldu, stream);                         \
  }

REFIT_ENTRY(f64, double)
REFIT_ENTRY(f32, float)
