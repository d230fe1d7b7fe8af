// The per-round re-fit of an ellipsoid stack before a chained uniform
// round, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: it is the XLA program of the JAX package's
// dynesty_tpu/internal/kernels.py:206 make_ellipsoid_refit, which the
// jitted round runs before every chained unif round
// (dynesty_tpu/internal/samplers.py:495-505), inside the one device
// program.  The port ran it as ~30 eager torch launches before each
// round's prologue (ops/ellipsoid_refit.py, ellipsoid_refit_plain, which
// these kernels are held against).  Here it is two kernels inside the
// round's captured prologue (internal/fused.py), writing straight into
// the wave's buffers.
//
// Two kernels, launched back to back on the caller's stream:
//   refit_assign, a thread a live point: its quadratic form
//     (x - c)^T A (x - c) in every slot under the dispatch's fit (inf on
//     a slot off the mask), in the order of unif_valid's forms
//     (d_l = x_l - c_l; t_r = sum_l A_rl d_l; sq = sum_r d_r t_r, left to
//     right), and the slot of the smallest with torch.argmin's rules: the
//     first minimum, and the first NaN before any number.
//   refit_fit, a block a slot: its members listed in the points' order
//     (warp ballots, a block prefix a chunk of 256 points); the count,
//     the mean and the MLE covariance of the centred members (the lower
//     triangle); the trace floor 1e-10 * max(tr / d, 1e-30) on the
//     diagonal; the Cholesky factor (column by column, right-looking);
//     ok = no pivot that is not positive (NaN included), every entry of
//     the factor finite, count >= d + 1, and no live point with a
//     coordinate that is not finite (the plain version's one-hot product
//     makes every mean NaN then: 0 * inf; refit_assign flags it a block).
//     A slot off the mask or not
//     ok copies the dispatch's fit and is done.  Otherwise the inverse of
//     the factor (forward substitution, a thread a column), am = Linv^T
//     Linv, each member's distance under am, their maximum (NaN wins),
//     f = sqrt(max(fmax, 1e-30) / (1 - 1e-3)) * expand, and the slot's
//     centre, axes L f, matrix am / f^2, log-volume sum log|L_ii| +
//     d log f + the d-ball's prefactor and mask.
//
// Determinism: no atomics.  Every sum (the counts, the mean, the
// covariance, the trace, the products of the factor and its inverse)
// runs in one fixed order: a sum over the members is taken in stripes
// (thread t an element and the members k = t mod S, in turn), then one
// thread an element adds the stripes in order; the maximum is a fixed
// tree.  Two launches on the same inputs give the same bits, so a run on
// the card reproduces itself and resumes bit for bit.  The orders are not
// cuBLAS's and cuSOLVER's, which the eager refit went through, so the
// results agree with the plain version to rounding (held at 1e-10
// relative in float64), not bit for bit.
//
// No ceiling on the dimension: the slot's matrices (the factor, its
// inverse, am) and its mean live in a global scratch row of
// 3 d^2 + d values, and its member list in a row of n ints (the wrapper
// makes both), so shared memory holds only the block's 256 partials.
//
// What bounds it on this card: latency, not bytes or operations.  At the
// eggbox's (1000 points, 32 slots, d 2) the inputs are ~24 kB (~7 ns at
// 3.35 TB/s) and at the heavy drive's (3000, 4, 3) ~72 kB; the work is a
// few hundred thousand flops.  Each kernel is a launch (~0.8 us) and a
// chain of dependent steps: the assignment one pass over the slots; the
// fit a member scan of n / 256 chunks, two stripe sums of ~count / S
// dependent loads each, d columns of the factor (three barriers each),
// the inverse and the containment pass.  One block a slot keeps every
// slot's steps on its own SM, at the cost of idle SMs for a stack of a
// few slots; a faster fit is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef long long i64;

namespace {

const int BLOCK = 256;
const int WARPS = BLOCK / 32;
// the pointer tables' lengths, and the one entry that may be null
const int N_ASSIGN = 6, N_FIT = 18, P_EXPAND = 7;

// refit_assign's operands, in the order of ops/ellipsoid_refit.py's table
struct AssignArgs {
  const void* u;      // the live points, rows of ldu values, d read
  const void* ctrs0;  // (m, d) the dispatch's fit
  const void* ams0;   // (m, d, d)
  const bool* mask;   // (m,)
  i64* idx;           // (n,) each point's slot
  int* nonfinite;     // (blocks,) a block's points: one coordinate not finite
};

// refit_fit's operands, in the order of ops/ellipsoid_refit.py's table
struct FitArgs {
  const void* u;         // the live points, rows of ldu values
  const i64* idx;        // (n,) refit_assign's slots
  const void* ctrs0;     // (m, d) the dispatch's fit
  const void* axes0;     // (m, d, d)
  const void* ams0;      // (m, d, d)
  const void* logvols0;  // (m,)
  const bool* mask;      // (m,)
  const void* expand;    // 0-d, or null (1)
  const void* pref;      // 0-d: the d-ball's log-volume prefactor
  int* members;          // (m, n) scratch: each slot's member list
  void* work;            // (m, 3 d^2 + d) scratch: L, Linv, am, mean
  void* ctrs;            // (m, d) out: the wave's buffers
  void* axes;            // (m, d, d) out
  void* ams;             // (m, d, d) out
  void* logvols;         // (m,) out
  bool* mask_out;        // (m,) out
  bool* keep;            // (m,) scratch: the slot re-fitted (mask & ok)
  const int* nonfinite;  // (blocks,) refit_assign's flags
};

template <typename T>
__device__ __forceinline__ bool is_nan(T x) {
  return x != x;
}

template <typename T>
__global__ void __launch_bounds__(BLOCK)
    refit_assign_kernel(AssignArgs a, int n, int m, int d, int ldu) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  // a coordinate that is not finite makes every slot's mean NaN in the
  // plain version (0 * inf in its one-hot product): the block says so
  bool finite = true;
  if (i < n)
    for (int l = 0; l < d; ++l)
      finite = finite && isfinite(((const T*)a.u)[(i64)i * ldu + l]);
  const int any = __syncthreads_or(!finite);
  if (threadIdx.x == 0) a.nonfinite[blockIdx.x] = any;
  if (i >= n) return;
  const T* x = (const T*)a.u + (i64)i * ldu;
  const T* c0 = (const T*)a.ctrs0;
  const T* A0 = (const T*)a.ams0;
  i64 best_j = 0;
  T best = (T)0;
  for (int j = 0; j < m; ++j) {
    T sq = (T)INFINITY;
    if (a.mask[j]) {
      const T* c = c0 + (i64)j * d;
      const T* A = A0 + (i64)j * d * d;
      sq = (T)0;
      for (int r = 0; r < d; ++r) {
        T t = (T)0;
        for (int l = 0; l < d; ++l) t += A[r * d + l] * (x[l] - c[l]);
        sq += (x[r] - c[r]) * t;
      }
    }
    // torch.argmin: the first minimum, and the first NaN before any number
    if (j == 0 || (!is_nan(best) && (is_nan(sq) || sq < best))) {
      best = sq;
      best_j = j;
    }
  }
  a.idx[i] = best_j;
}

// (r, c), c <= r, of the e-th entry of a lower triangle taken row by row
__device__ __forceinline__ void lower_entry(int e, int& r, int& c) {
  r = 0;
  while ((r + 1) * (r + 2) / 2 <= e) ++r;
  c = e - r * (r + 1) / 2;
}

// Sums over the slot's cnt members (rows of u listed in mem) of E
// elements, each over safe, in a fixed order: thread t takes element
// e0 + t / S and the members k = t mod S, S + t mod S, ... in turn; then
// one thread an element adds its S partials in order.  COV false: element
// e is coordinate e (the mean, written to mean[e]); true: lower entry e of
// the centred members' outer product (written to L[r * d + c]).
template <typename T, bool COV>
__device__ void member_sums(const T* __restrict__ u, const int* mem,
                            int cnt, int d, int ldu, int E, T safe,
                            const T* mean, T* out, T* part) {
  const int t = threadIdx.x;
  for (int e0 = 0; e0 < E; e0 += BLOCK) {
    const int C = min(E - e0, BLOCK);
    const int S = BLOCK / C;
    if (t < C * S) {
      const int e = e0 + t / S, s = t % S;
      int r = e, c = e;
      if (COV) lower_entry(e, r, c);
      const T mr = COV ? mean[r] : (T)0, mc = COV ? mean[c] : (T)0;
      T acc = (T)0;
#pragma unroll 4
      for (int k = s; k < cnt; k += S) {
        const T* x = u + (i64)mem[k] * ldu;
        acc += COV ? (x[r] - mr) * (x[c] - mc) : x[r];
      }
      part[t] = acc;
    }
    __syncthreads();
    if (t < C) {
      T acc = (T)0;
      for (int s = 0; s < S; ++s) acc += part[t * S + s];
      const int e = e0 + t;
      int r = e, c = e;
      if (COV) lower_entry(e, r, c);
      out[COV ? r * d + c : e] = acc / safe;
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(BLOCK)
    refit_fit_kernel(FitArgs a, int n, int m, int d, int ldu) {
  __shared__ T part[BLOCK];
  __shared__ int wcount[WARPS];
  __shared__ int bad;
  __shared__ T sf, slogvol;
  const int j = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int dd = d * d;
  const T* u = (const T*)a.u;
  int* mem = a.members + (i64)j * n;
  T* W = (T*)a.work + (i64)j * (3 * dd + d);
  T *L = W, *Li = W + dd, *Am = W + 2 * dd, *mean = W + 3 * dd;

  // the members, in the points' order
  int cnt = 0;
  for (int base = 0; base < n; base += BLOCK) {
    const int i = base + tid;
    const bool in = i < n && a.idx[i] == (i64)j;
    const unsigned bal = __ballot_sync(0xffffffffu, in);
    if (lane == 0) wcount[warp] = __popc(bal);
    __syncthreads();
    int before = cnt, chunk = 0;
    for (int w = 0; w < WARPS; ++w) {
      if (w < warp) before += wcount[w];
      chunk += wcount[w];
    }
    if (in) mem[before + __popc(bal & ((1u << lane) - 1u))] = i;
    cnt += chunk;
    __syncthreads();
  }
  if (tid == 0) bad = 0;
  const T safe = cnt > 1 ? (T)cnt : (T)1;
  int poison = 0;
  for (int b = tid; b < (n + BLOCK - 1) / BLOCK; b += BLOCK)
    poison |= a.nonfinite[b];
  poison = __syncthreads_or(poison);

  // the mean, then the centred members' covariance (lower triangle)
  member_sums<T, false>(u, mem, cnt, d, ldu, d, safe, mean, mean, part);
  member_sums<T, true>(u, mem, cnt, d, ldu, d * (d + 1) / 2, safe, mean, L,
                       part);

  // the conditioning floor on the diagonal
  if (tid == 0) {
    T tr = (T)0;
    for (int r = 0; r < d; ++r) tr += L[r * d + r];
    tr = tr / (T)d;
    const T fl = (T)1e-10 * (is_nan(tr) || tr > (T)1e-30 ? tr : (T)1e-30);
    for (int r = 0; r < d; ++r) L[r * d + r] = L[r * d + r] + fl;
  }
  __syncthreads();

  // Cholesky, right-looking, in place on the lower triangle
  for (int k = 0; k < d; ++k) {
    if (tid == 0) {
      const T p = L[k * d + k];
      if (!(p > (T)0)) bad = 1;
      L[k * d + k] = sqrt(p);
    }
    __syncthreads();
    const T lkk = L[k * d + k];
    for (int r = k + 1 + tid; r < d; r += BLOCK) L[r * d + k] /= lkk;
    __syncthreads();
    for (int p = tid; p < dd; p += BLOCK) {
      const int r = p / d, c = p % d;
      if (c > k && c <= r) L[p] -= L[r * d + k] * L[c * d + k];
    }
    __syncthreads();
  }
  bool finite = true;
  for (int p = tid; p < dd; p += BLOCK)
    if (p % d <= p / d && !isfinite(L[p])) finite = false;
  const bool all_finite = __syncthreads_and(finite);
  const bool keep =
      a.mask[j] && !bad && all_finite && !poison && cnt >= d + 1;

  T* ctrs = (T*)a.ctrs + (i64)j * d;
  T* axes = (T*)a.axes + (i64)j * dd;
  T* ams = (T*)a.ams + (i64)j * dd;
  if (tid == 0) {
    a.mask_out[j] = a.mask[j];
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
  // column: x_c = 1 / L_cc, x_r = (0 - sum_{c<=k<r} L_rk x_k) / L_rr
  for (int c = tid; c < d; c += BLOCK) {
    for (int r = 0; r < c; ++r) Li[r * d + c] = (T)0;
    Li[c * d + c] = (T)1 / L[c * d + c];
    for (int r = c + 1; r < d; ++r) {
      T s = (T)0;
      for (int k = c; k < r; ++k) s += L[r * d + k] * Li[k * d + c];
      Li[r * d + c] = ((T)0 - s) / L[r * d + r];
    }
  }
  __syncthreads();
  // am = Linv^T Linv (cov^-1), over the rows where both columns are set
  for (int p = tid; p < dd; p += BLOCK) {
    const int r = p / d, c = p % d;
    T s = (T)0;
    for (int k = r > c ? r : c; k < d; ++k) s += Li[k * d + r] * Li[k * d + c];
    Am[p] = s;
  }
  __syncthreads();

  // the members' distances under am, their maximum from 0 (NaN wins)
  T fmax = (T)0;
  for (int k = tid; k < cnt; k += BLOCK) {
    const T* x = u + (i64)mem[k] * ldu;
    T sq = (T)0;
    for (int r = 0; r < d; ++r) {
      T t = (T)0;
      for (int l = 0; l < d; ++l) t += Am[r * d + l] * (x[l] - mean[l]);
      sq += (x[r] - mean[r]) * t;
    }
    if (is_nan(sq) || sq > fmax) fmax = is_nan(fmax) ? fmax : sq;
  }
  part[tid] = fmax;
  __syncthreads();
  for (int h = BLOCK / 2; h > 0; h >>= 1) {
    if (tid < h) {
      const T o = part[tid + h], v = part[tid];
      if (!is_nan(v) && (is_nan(o) || o > v)) part[tid] = o;
    }
    __syncthreads();
  }
  if (tid == 0) {
    const T fm = part[0];
    const T cl = is_nan(fm) || fm > (T)1e-30 ? fm : (T)1e-30;
    const T ex = a.expand ? *(const T*)a.expand : (T)1;
    const T f = sqrt(cl / (T)(1.0 - 1e-3)) * ex;
    T lv = (T)0;
    for (int r = 0; r < d; ++r) lv += log(fabs(L[r * d + r]));
    sf = f;
    slogvol = lv + (T)d * log(f) + *(const T*)a.pref;
  }
  __syncthreads();
  const T f = sf, f2 = f * f;
  for (int p = tid; p < d; p += BLOCK) ctrs[p] = mean[p];
  for (int p = tid; p < dd; p += BLOCK) {
    axes[p] = (p % d <= p / d ? L[p] : (T)0) * f;
    ams[p] = Am[p] / f2;
  }
  if (tid == 0) ((T*)a.logvols)[j] = slogvol;
}

int check_table(void* const* p, int len, int may_be_null) {
  for (int k = 0; k < len; ++k)
    if (!p[k] && k != may_be_null) return (int)cudaErrorInvalidValue;
  return 0;
}

template <typename T>
int launch_assign(void* const* p, int n, int m, int d, int ldu,
                  void* stream) {
  if (n < 1 || m < 1 || d < 1 || ldu < d || check_table(p, N_ASSIGN, -1))
    return (int)cudaErrorInvalidValue;
  AssignArgs a;
  a.u = p[0];
  a.ctrs0 = p[1];
  a.ams0 = p[2];
  a.mask = (const bool*)p[3];
  a.idx = (i64*)p[4];
  a.nonfinite = (int*)p[5];
  refit_assign_kernel<T><<<(n + BLOCK - 1) / BLOCK, BLOCK, 0,
                           (cudaStream_t)stream>>>(a, n, m, d, ldu);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fit(void* const* p, int n, int m, int d, int ldu, void* stream) {
  if (n < 1 || m < 1 || d < 1 || ldu < d ||
      check_table(p, N_FIT, P_EXPAND))
    return (int)cudaErrorInvalidValue;
  FitArgs a;
  a.u = p[0];
  a.idx = (const i64*)p[1];
  a.ctrs0 = p[2];
  a.axes0 = p[3];
  a.ams0 = p[4];
  a.logvols0 = p[5];
  a.mask = (const bool*)p[6];
  a.expand = p[P_EXPAND];
  a.pref = p[8];
  a.members = (int*)p[9];
  a.work = p[10];
  a.ctrs = p[11];
  a.axes = p[12];
  a.ams = p[13];
  a.logvols = p[14];
  a.mask_out = (bool*)p[15];
  a.keep = (bool*)p[16];
  a.nonfinite = (const int*)p[17];
  refit_fit_kernel<T><<<m, BLOCK, 0, (cudaStream_t)stream>>>(a, n, m, d,
                                                             ldu);
  return (int)cudaGetLastError();
}

}  // namespace

// p: the operands' pointers in the order of AssignArgs / FitArgs
// (ops/ellipsoid_refit.py); n live points, m slots, d dimensions, ldu
// the points' row stride
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
