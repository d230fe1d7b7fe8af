// The doubling form of the rslice/slice round, for Hopper (sm_90a).
//
// Replaces the loop bodies of the JAX package's jitted doubling round:
// dynesty_tpu/internal/kernels.py:594-607 (the step's start), the doubling
// lax.while_loop body :640-655, the acceptance test's body :569-585
// (Neal 2003, algorithm 6) and the shrink body :670-693 (doubling branch
// :678-682), all inside round_fn :718, which XLA runs on the device.  The
// port's host loop (dynesty_tpu_torch/internal/kernels.py, doubling_round)
// reads one device flag a loop turn and calls the user's batched
// likelihood between these kernels.  The eager code they were moved from
// stays as the plain versions (dynesty_tpu_torch/ops/proposals.py,
// doubling_*_plain) that these kernels are held against bit for bit.
//
// Four kernels, on the round's own buffers (ops/proposals.py,
// DoublingRound: made once per round shape, the argument tables filled
// once):
//   doubling_point: the position each likelihood call reads, by mode: the
//     step's two end probes (its interval (-r0, 1 - r0), the step's capped
//     direction and start point taken into the round's buffers), the side
//     a doubling evaluates (where(go_left, l, r) after the doubling), a
//     shrink candidate l + r * (right - left), or a halving's mid; then the
//     point u0 + x * direction, its cube check with the lane's mask, and
//     the point clamped into the cube (where the likelihood is evaluated).
//     Zeroes the `any` flag for the kernel after the likelihood to raise.
//   doubling_expand: after the end probes, the step's initial state; after
//     a doubling, one side of each active lane's interval doubled (the side
//     drawn at random), its end value, the evaluations, the expansion tally
//     (grow clamped at 2^30), and whether the lane still expands.
//   doubling_halve: one halving of the acceptance test for the lanes whose
//     candidate is above the threshold: the sides, the divergence flag, the
//     rejection, the evaluations.
//   doubling_shrink: a shrink candidate's outcome before the halvings (its
//     logl, whether it is above the threshold, the test's start), and its
//     resolution after them (the test's verdict and evaluations, the lane's
//     point where it accepts, the shrunk interval where it rejects).
//
// What bounds it on this card: nothing the card measures.  A call moves a
// few values a lane and a row of ndim values (~20 kB at q 256, ndim 3:
// ~0.006 us at 3.35 TB/s); a launch costs microseconds of latency, and the
// host's Python around it tens.  The design answer is to take the host
// out of each loop turn: the round's buffers and the argument tables are
// made once per round shape, the clamp and the -inf mask (once torch ops
// around the likelihood) are folded in here, each kernel takes only device
// pointers, and where the likelihood runs on the card each segment of the
// round between two host reads -- the step's start, a doubling, a shrink
// candidate, a halving, a shrink's resolution: the draws, these kernels,
// the batched likelihood, the blob's copy or select and the flag's copy to
// pinned host memory -- is captured once as a CUDA graph and replayed, as
// the JAX package traces its loop bodies once.  doubling_point runs one
// thread per (lane, dimension) element, so that a warp's loads and stores
// are neighbouring addresses (a lane's cube check is an AND over its
// threads, as in rwalk_step.cu); the other three one thread a lane.
//
// Rounding: each eager op rounds once, so every product and sum here is an
// explicit round-to-nearest intrinsic, which nvcc never contracts into an
// FMA (u0 + x * d, left + r * (right - left) and 0.5 * (l + r) would
// otherwise fuse).  Constants are taken in the round's type, as torch takes
// a Python number against a tensor.  Comparisons are IEEE, NaN false, as
// torch's; the clamp is torch's (NaN passes).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef long long i64;

namespace {

template <typename T> struct Op;

template <> struct Op<double> {
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
};

template <> struct Op<float> {
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
};

// doubling_point's modes (ops/proposals.py, P_*)
enum { P_START_L = 0, P_START_R = 1, P_DOUBLE = 2, P_SHRINK = 3, P_HALVE = 4 };
// doubling_expand's and doubling_shrink's (X_*, S_*)
enum { X_INIT = 0, X_DOUBLE = 1 };
enum { S_CANDIDATE = 0, S_RESOLVE = 1 };

const int BLOCK = 128;

template <typename T>
struct PointArgs {
  i64* step;            // the step whose direction the start takes
  const T* dirs;        // (q, n_steps, ndim), lengths capped
  T* dir;               // (q, ndim): the step's direction
  const T* u;           // (q, ndim): the lanes' points
  T* u0;                // (q, ndim): the step's start points
  const T* draw;        // (q,): r0, the doubling's side, the shrink's draw
  T* left;              // the doubling's interval
  T* right;
  const T* sl;          // the shrink's interval
  const T* sr;
  const T* lhat;        // the halving's interval
  const T* rhat;
  const bool* active;   // the lanes that double
  const bool* s_active; // the lanes that shrink
  const bool* h_active; // the lanes that halve
  const bool* strict;   // (ndim,) or null: all strict
  T* uclamp;            // the point clamped into [0, 1], NaN kept
  bool* incube;         // cube check & the mode's lane mask
  bool* incube_l;       // the left end probe's cube check
  T* x1;                // the shrink candidate's position
  T* u_c;               // (q, ndim): the shrink candidate's point
  bool* any;
  int q, ndim, n_steps, mode;
};

// One thread per (lane, dimension): a lane is a group of `width` threads
// (a power of two <= 32, or a multiple of 32 that loops over the
// dimensions past it), `lanes` groups a block.  The lane's position is
// computed by each of its threads; its first thread writes the lane's
// values.
template <typename T>
__global__ void __launch_bounds__(BLOCK) doubling_point_kernel(
    PointArgs<T> a, int width, int lanes) {
  typedef Op<T> O;
  __shared__ int lane_in[BLOCK / 32];
  const int t = threadIdx.x;
  const int g = t / width, sub = t - g * width;
  const int k = blockIdx.x * lanes + g;
  if (blockIdx.x == 0 && t == 0) *a.any = false;
  if (width > 32 && sub == 0) lane_in[g] = 1;
  __syncthreads();

  bool in = true, mask = true;
  T x = (T)0.0, l = (T)0.0, r = (T)0.0;
  if (k < a.q) {
    switch (a.mode) {
      case P_START_L: {
        const T r0 = a.draw[k];
        l = -r0;
        r = O::sub((T)1.0, r0);
        x = l;
        break;
      }
      case P_START_R:
        x = a.right[k];
        break;
      case P_DOUBLE: {
        mask = a.active[k];
        const bool go_left = a.draw[k] < (T)0.5;
        const T lo = a.left[k], hi = a.right[k];
        const T w = O::sub(hi, lo);
        const T l2 = (mask && go_left) ? O::sub(lo, w) : lo;
        const T r2 = (mask && !go_left) ? O::add(hi, w) : hi;
        x = go_left ? l2 : r2;
        break;
      }
      case P_SHRINK: {
        mask = a.s_active[k];
        const T lo = a.sl[k];
        x = O::add(lo, O::mul(a.draw[k], O::sub(a.sr[k], lo)));
        break;
      }
      default:  // P_HALVE
        mask = a.h_active[k];
        x = O::mul((T)0.5, O::add(a.lhat[k], a.rhat[k]));
    }
    const i64 row = (i64)k * a.ndim;
    // the step index clamped to the last step, as a round never passes it
    const i64 step = *a.step < a.n_steps - 1 ? *a.step : a.n_steps - 1;
    const T* drow = a.dirs + ((i64)k * a.n_steps + step) * a.ndim;
    for (int d = sub; d < a.ndim; d += width) {
      T dd, base;
      if (a.mode == P_START_L) {
        dd = drow[d];
        base = a.u[row + d];
        a.dir[row + d] = dd;
        a.u0[row + d] = base;
      } else {
        dd = a.dir[row + d];
        base = a.u0[row + d];
      }
      const T p = O::add(base, O::mul(x, dd));
      if (a.mode == P_SHRINK) a.u_c[row + d] = p;
      // torch's CUDA clamp: NaN passes, else min(max(p, 0), 1)
      a.uclamp[row + d] = isnan(p) ? p : fmin(fmax(p, (T)0.0), (T)1.0);
      const bool strict = a.strict == nullptr || a.strict[d];
      in = in && (strict ? (p > (T)0.0 && p < (T)1.0)
                         : (p > (T)-0.5 && p < (T)1.5));
    }
  }
  // the cube check: AND over the lane's threads (threads past q vote true)
  bool all_in;
  if (width <= 32) {
    const unsigned vote = __ballot_sync(0xffffffffu, in);
    const unsigned group =
        width == 32 ? 0xffffffffu
                    : ((1u << width) - 1u) << ((t & 31) & ~(width - 1));
    all_in = (vote & group) == group;
  } else {
    if (!__all_sync(0xffffffffu, in) && (t & 31) == 0) lane_in[g] = 0;
    __syncthreads();
    all_in = lane_in[g] != 0;
  }
  if (sub != 0 || k >= a.q) return;
  if (a.mode == P_START_L) {
    a.incube_l[k] = all_in;
    a.left[k] = l;
    a.right[k] = r;
  } else {
    a.incube[k] = all_in && mask;
  }
  if (a.mode == P_SHRINK) a.x1[k] = x;
}

template <typename T>
struct ExpandArgs {
  const bool* incube_l;
  const bool* incube;
  const T* logl_l;      // the left end probe's raw values (X_INIT)
  const T* logl_x;      // the likelihood's raw values, masked here
  const T* draw;
  const T* loglstar;
  T* left;
  T* right;
  T* fl;
  T* fr;
  T* sl;
  T* sr;
  bool* active;
  bool* s_active;
  i64* grow;
  i64* nc;
  i64* n_exp;
  i64* step;
  bool* any;
  int q, mode;
};

template <typename T>
__global__ void __launch_bounds__(BLOCK) doubling_expand_kernel(
    ExpandArgs<T> a) {
  typedef Op<T> O;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= a.q) return;
  const T ls = *a.loglstar;
  // the mask the eager loop applied after the likelihood call
  const T lx = a.incube[k] ? a.logl_x[k] : (T)-INFINITY;
  T l = a.left[k], r = a.right[k], fl, fr;
  bool act;
  if (a.mode == X_INIT) {
    fl = a.incube_l[k] ? a.logl_l[k] : (T)-INFINITY;
    fr = lx;
    a.nc[k] += 2;
    a.grow[k] = 1;
    act = fl > ls || fr > ls;
    a.s_active[k] = true;
    if (k == 0) *a.step += 1;
  } else {
    const bool a0 = a.active[k];
    const bool go_left = a.draw[k] < (T)0.5;
    const T w = O::sub(r, l);
    if (a0 && go_left) l = O::sub(l, w);
    if (a0 && !go_left) r = O::add(r, w);
    fl = (a0 && go_left) ? lx : a.fl[k];
    fr = (a0 && !go_left) ? lx : a.fr[k];
    if (a0) {
      const i64 g = a.grow[k];
      a.nc[k] += 1;
      a.n_exp[k] += g;
      a.grow[k] = g * 2 < ((i64)1 << 30) ? g * 2 : ((i64)1 << 30);
    }
    act = a0 && (fl > ls || fr > ls);
    a.left[k] = l;
    a.right[k] = r;
  }
  a.fl[k] = fl;
  a.fr[k] = fr;
  a.sl[k] = l;
  a.sr[k] = r;
  a.active[k] = act;
  if (act) *a.any = true;
}

template <typename T>
struct HalveArgs {
  const bool* incube;
  const T* logl_x;      // the likelihood's raw values, masked here
  const T* loglstar;
  const T* x1;
  T* lhat;
  T* rhat;
  T* f_lhat;
  T* f_rhat;
  bool* dflag;
  bool* reject;
  bool* h_active;
  i64* d_nc;
  bool* any;
  int q;
};

template <typename T>
__global__ void __launch_bounds__(BLOCK) doubling_halve_kernel(
    HalveArgs<T> a) {
  typedef Op<T> O;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= a.q) return;
  const T ls = *a.loglstar, x1 = a.x1[k];
  T lh = a.lhat[k], rh = a.rhat[k], flh = a.f_lhat[k], frh = a.f_rhat[k];
  const T mid = O::mul((T)0.5, O::add(lh, rh));
  const bool df = a.dflag[k] || ((T)0.0 < mid && mid <= x1) ||
                  (x1 < mid && mid <= (T)0.0);
  const bool go_right = x1 < mid;  // shrink the right side toward x1
  const bool act = a.h_active[k];
  const T lm = a.incube[k] ? a.logl_x[k] : (T)-INFINITY;
  a.d_nc[k] += act;
  if (act && go_right) {
    frh = lm;
    rh = mid;
  }
  if (act && !go_right) {
    flh = lm;
    lh = mid;
  }
  const bool newly = act && df && ls >= flh && ls >= frh;
  const bool still = act && !newly && O::sub(rh, lh) > (T)1.1;
  a.lhat[k] = lh;
  a.rhat[k] = rh;
  a.f_lhat[k] = flh;
  a.f_rhat[k] = frh;
  a.dflag[k] = df;
  if (newly) a.reject[k] = true;
  a.h_active[k] = still;
  if (still) *a.any = true;
}

template <typename T>
struct ShrinkArgs {
  const bool* incube;
  const T* v_x;         // (q, npdim): the candidate's v (S_CANDIDATE)
  const T* logl_x;      // the candidate's raw values (S_CANDIDATE)
  const T* loglstar;
  bool* s_active;
  bool* good;
  const T* left;        // the doubling's interval and end values
  const T* right;
  const T* fl;
  const T* fr;
  T* lhat;
  T* rhat;
  T* f_lhat;
  T* f_rhat;
  bool* dflag;
  bool* reject;
  bool* h_active;
  i64* d_nc;
  T* v_c;               // (q, npdim): the candidate's v
  T* logl_c;            // the candidate's logl, masked
  i64* nc;
  i64* n_con;
  T* u;                 // (q, ndim): the lanes' points
  T* v;
  T* logl;
  const T* u_c;
  const T* x1;
  T* sl;
  T* sr;
  bool* newly;          // the lanes that accept (the blob's select)
  bool* any;            // a flag: does any lane run the halving test
  bool* any_shrink;     // a flag: does any lane shrink on
  int q, ndim, npdim, mode;
};

template <typename T>
__global__ void __launch_bounds__(BLOCK) doubling_shrink_kernel(
    ShrinkArgs<T> a) {
  typedef Op<T> O;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (a.mode == S_CANDIDATE && blockIdx.x == 0 && threadIdx.x == 0)
    *a.any_shrink = false;
  if (k >= a.q) return;
  const T ls = *a.loglstar;
  const bool act = a.s_active[k];
  if (a.mode == S_CANDIDATE) {
    const T lx = a.incube[k] ? a.logl_x[k] : (T)-INFINITY;
    for (int d = 0; d < a.npdim; ++d)
      a.v_c[(i64)k * a.npdim + d] = a.v_x[(i64)k * a.npdim + d];
    a.logl_c[k] = lx;
    a.nc[k] += act;
    a.n_con[k] += act;
    const bool good = lx > ls;
    a.good[k] = good;
    // the acceptance test's start on the doubling's interval
    const T l = a.left[k], r = a.right[k];
    const bool h = O::sub(r, l) > (T)1.1 && act && good;
    a.h_active[k] = h;
    a.lhat[k] = l;
    a.rhat[k] = r;
    a.f_lhat[k] = a.fl[k];
    a.f_rhat[k] = a.fr[k];
    a.dflag[k] = false;
    a.reject[k] = false;
    a.d_nc[k] = 0;
    if (h) *a.any = true;
    return;
  }
  // S_RESOLVE
  const bool good0 = a.good[k];
  if (act && good0) a.nc[k] += a.d_nc[k];
  const bool good = good0 && !a.reject[k];
  const bool newly = act && good;
  if (newly) {
    for (int d = 0; d < a.ndim; ++d)
      a.u[(i64)k * a.ndim + d] = a.u_c[(i64)k * a.ndim + d];
    for (int d = 0; d < a.npdim; ++d)
      a.v[(i64)k * a.npdim + d] = a.v_c[(i64)k * a.npdim + d];
    a.logl[k] = a.logl_c[k];
  }
  const bool bad = act && !good;
  const T x = a.x1[k];
  if (bad && x < (T)0.0) a.sl[k] = x;
  if (bad && x > (T)0.0) a.sr[k] = x;
  a.s_active[k] = bad;
  a.newly[k] = newly;
  if (bad) *a.any_shrink = true;
}

// threads a lane for doubling_point
int lane_width(int ndim) {
  if (ndim > 32) return ndim >= BLOCK ? BLOCK : (ndim + 31) / 32 * 32;
  int w = 1;
  while (w < ndim) w *= 2;
  return w;
}

unsigned blocks(int q) { return (unsigned)((q + BLOCK - 1) / BLOCK); }

template <typename T>
int launch_point(void* const* p, int q, int ndim, int n_steps, int mode,
                 void* stream) {
  if (q < 1 || ndim < 1 || n_steps < 1 || mode < P_START_L ||
      mode > P_HALVE)
    return (int)cudaErrorInvalidValue;
  PointArgs<T> a{(i64*)p[0],        (const T*)p[1],    (T*)p[2],
                 (const T*)p[3],    (T*)p[4],          (const T*)p[5],
                 (T*)p[6],          (T*)p[7],          (const T*)p[8],
                 (const T*)p[9],    (const T*)p[10],   (const T*)p[11],
                 (const bool*)p[12], (const bool*)p[13], (const bool*)p[14],
                 (const bool*)p[15], (T*)p[16],        (bool*)p[17],
                 (bool*)p[18],      (T*)p[19],         (T*)p[20],
                 (bool*)p[21],      q,                 ndim,
                 n_steps,           mode};
  const int width = lane_width(ndim), lanes = BLOCK / width;
  doubling_point_kernel<T><<<(q + lanes - 1) / lanes, lanes * width, 0,
                             (cudaStream_t)stream>>>(a, width, lanes);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_expand(void* const* p, int q, int mode, void* stream) {
  if (q < 1 || (mode != X_INIT && mode != X_DOUBLE) || !p[3] ||
      (mode == X_INIT && !p[2]))
    return (int)cudaErrorInvalidValue;
  ExpandArgs<T> a{(const bool*)p[0], (const bool*)p[1], (const T*)p[2],
                  (const T*)p[3],    (const T*)p[4],    (const T*)p[5],
                  (T*)p[6],          (T*)p[7],          (T*)p[8],
                  (T*)p[9],          (T*)p[10],         (T*)p[11],
                  (bool*)p[12],      (bool*)p[13],      (i64*)p[14],
                  (i64*)p[15],       (i64*)p[16],       (i64*)p[17],
                  (bool*)p[18],      q,                 mode};
  doubling_expand_kernel<T><<<blocks(q), BLOCK, 0, (cudaStream_t)stream>>>(
      a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_halve(void* const* p, int q, void* stream) {
  if (q < 1 || !p[1]) return (int)cudaErrorInvalidValue;
  HalveArgs<T> a{(const bool*)p[0], (const T*)p[1], (const T*)p[2],
                 (const T*)p[3],    (T*)p[4],       (T*)p[5],
                 (T*)p[6],          (T*)p[7],       (bool*)p[8],
                 (bool*)p[9],       (bool*)p[10],   (i64*)p[11],
                 (bool*)p[12],      q};
  doubling_halve_kernel<T><<<blocks(q), BLOCK, 0, (cudaStream_t)stream>>>(
      a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_shrink(void* const* p, int q, int ndim, int npdim, int mode,
                  void* stream) {
  if (q < 1 || ndim < 1 || npdim < 0 ||
      (mode != S_CANDIDATE && mode != S_RESOLVE) ||
      (mode == S_CANDIDATE && (!p[2] || (npdim > 0 && !p[1]))))
    return (int)cudaErrorInvalidValue;
  ShrinkArgs<T> a{(const bool*)p[0], (const T*)p[1],  (const T*)p[2],
                  (const T*)p[3],    (bool*)p[4],     (bool*)p[5],
                  (const T*)p[6],    (const T*)p[7],  (const T*)p[8],
                  (const T*)p[9],    (T*)p[10],       (T*)p[11],
                  (T*)p[12],         (T*)p[13],       (bool*)p[14],
                  (bool*)p[15],      (bool*)p[16],    (i64*)p[17],
                  (T*)p[18],         (T*)p[19],       (i64*)p[20],
                  (i64*)p[21],       (T*)p[22],       (T*)p[23],
                  (T*)p[24],         (const T*)p[25], (const T*)p[26],
                  (T*)p[27],         (T*)p[28],       (bool*)p[29],
                  (bool*)p[30],      (bool*)p[31],    q,
                  ndim,              npdim,           mode};
  doubling_shrink_kernel<T><<<blocks(q), BLOCK, 0, (cudaStream_t)stream>>>(
      a);
  return (int)cudaGetLastError();
}

}  // namespace

// p: the tensors' pointers in the order of each kernel's argument struct
#define DOUBLING_ENTRY(TAG, T)                                             \
  extern "C" int dynesty_doubling_point_##TAG(void* const* p, int q,       \
                                              int ndim, int n_steps,       \
                                              int mode, void* stream) {    \
    return launch_point<T>(p, q, ndim, n_steps, mode, stream);             \
  }                                                                        \
  extern "C" int dynesty_doubling_expand_##TAG(void* const* p, int q,      \
                                               int mode, int unused1,      \
                                               int unused2, void* stream) {\
    (void)unused1;                                                         \
    (void)unused2;                                                         \
    return launch_expand<T>(p, q, mode, stream);                           \
  }                                                                        \
  extern "C" int dynesty_doubling_halve_##TAG(void* const* p, int q,       \
                                              int unused1, int unused2,    \
                                              int unused3, void* stream) { \
    (void)unused1;                                                         \
    (void)unused2;                                                         \
    (void)unused3;                                                         \
    return launch_halve<T>(p, q, stream);                                  \
  }                                                                        \
  extern "C" int dynesty_doubling_shrink_##TAG(void* const* p, int q,      \
                                               int ndim, int npdim,        \
                                               int mode, void* stream) {   \
    return launch_shrink<T>(p, q, ndim, npdim, mode, stream);              \
  }

DOUBLING_ENTRY(f64, double)
DOUBLING_ENTRY(f32, float)
