// The per-iteration updates of the rslice/slice stepping-out state machine,
// for Hopper (sm_90a).
//
// Replaces the body of the JAX package's jitted lax.while_loop over the
// lanes' slice state machines: dynesty_tpu/internal/kernels.py:763
// round_fn_sm, body :801-874, loop :876, which XLA runs on the device.
// The port's host loop (dynesty_tpu_torch/internal/kernels.py,
// slice_state_machine) reads one device flag an iteration and calls the
// user's batched likelihood in between; around that call the eager code
// took ~90 small launches an iteration.  It stays as the plain version
// (dynesty_tpu_torch/ops/proposals.py, slice_propose_plain and
// slice_advance_plain) that these kernels are held against bit for bit.
//
// Two kernels an iteration, one thread a lane:
//   slice_propose: the lane's position x by its phase (the interval's
//     ends, one step beyond them, or a uniform point inside), the lane's
//     current slice direction, upos = u0 + x * dirc, the point clamped
//     into the cube (where the likelihood is evaluated) and the cube
//     check; zeroes the any_active flag.
//   slice_advance: after the likelihood at the clamped point, the lane's
//     log-likelihood masked to -inf outside the cube, then the whole
//     update of the lane's state (interval ends and their values,
//     counters, acceptance and the reset into the next slice step, the
//     phase transition, the sticky expansion warning); raises any_active
//     where the lane is short of its last slice step.  The state lives in
//     the round's own buffers and is updated in place.
//
// What bounds it on this card: nothing the card measures.  An iteration
// moves ~40 bytes a lane plus a few rows of ndim values (~30 kB at q 256,
// ndim 3: ~0.01 us at 3.35 TB/s) and does a few operations a lane; a
// launch costs microseconds of latency, and the host's Python around it
// tens.  The design answer is to take the host out of the iteration: the
// round's buffers and the two argument tables are made once per round
// shape, the clamp and the mask (once torch ops around the likelihood)
// are folded in here, and where the likelihood runs on the card the whole
// iteration -- the draws (uniform_ on the round's generator), these two
// kernels, the user's batched likelihood, the blob select and the flag's
// copy to pinned host memory -- is captured once as a CUDA graph and
// replayed once an iteration, as the JAX package traces its loop body
// once.  The kernels take only device pointers, so a replay reads the
// round's loglstar and draws from the same buffers as an eager launch.
//
// Rounding: each eager op rounds once, so every product and sum here is an
// explicit round-to-nearest intrinsic, which nvcc never contracts into an
// FMA (left + u * (right - left) and u0 + x * dirc would otherwise fuse).
// Comparisons are IEEE, NaN false, as torch's.

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

enum { PH_INIT_L = 0, PH_INIT_R = 1, PH_EXP_L = 2, PH_EXP_R = 3, PH_SHRINK = 4 };

const int BLOCK = 128;

template <typename T>
struct ProposeArgs {
  const i64* s;
  const i64* phase;
  const T* left;
  const T* right;
  const T* u0;
  const T* u_sh;
  const T* dirs;       // (q, n_steps, ndim), lengths capped
  const bool* strict;  // (ndim,) or null: all strict
  T* x;
  T* upos;
  T* uclamp;           // upos clamped into [0, 1], NaN kept (torch.clamp)
  bool* incube;
  bool* any_active;
  int q, n_steps, ndim;
};

template <typename T>
__global__ void slice_propose_kernel(ProposeArgs<T> a) {
  typedef Op<T> O;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k == 0) *a.any_active = false;
  if (k >= a.q) return;
  const i64 s = a.s[k], ph = a.phase[k];
  const T l = a.left[k], r = a.right[k];
  T x;
  if (ph == PH_INIT_L)
    x = l;
  else if (ph == PH_INIT_R)
    x = r;
  else if (ph == PH_EXP_L)
    x = O::sub(l, (T)1.0);
  else if (ph == PH_EXP_R)
    x = O::add(r, (T)1.0);
  else
    x = O::add(l, O::mul(a.u_sh[k], O::sub(r, l)));
  a.x[k] = x;
  const i64 si = s < a.n_steps - 1 ? s : a.n_steps - 1;
  const T* dirc = a.dirs + ((i64)k * a.n_steps + si) * a.ndim;
  const T* u0 = a.u0 + (i64)k * a.ndim;
  T* up = a.upos + (i64)k * a.ndim;
  T* uc = a.uclamp + (i64)k * a.ndim;
  bool in = true;
  for (int d = 0; d < a.ndim; ++d) {
    const T p = O::add(u0[d], O::mul(x, dirc[d]));
    up[d] = p;
    // torch's CUDA clamp: NaN passes, else min(max(p, 0), 1)
    uc[d] = isnan(p) ? p : fmin(fmax(p, (T)0.0), (T)1.0);
    const bool strict = a.strict == nullptr || a.strict[d];
    in = in && (strict ? (p > (T)0.0 && p < (T)1.0)
                       : (p > (T)-0.5 && p < (T)1.5));
  }
  a.incube[k] = in && s < a.n_steps;
}

template <typename T>
struct AdvanceArgs {
  i64* s;
  i64* phase;
  T* left;
  T* right;
  T* fl;
  T* fr;
  T* u;
  T* v;
  T* logl;
  T* u0;
  i64* nc;
  i64* n_exp;
  i64* n_con;
  i64* exp_step;
  bool* warn;
  bool* any_active;
  bool* acc;
  const T* x;
  const T* upos;
  const bool* incube;
  const T* v_x;
  const T* logl_x;     // the likelihood's raw values, masked here
  const T* u_r0;
  const T* loglstar;
  int q, n_steps, ndim, npdim;
};

template <typename T>
__global__ void slice_advance_kernel(AdvanceArgs<T> a) {
  typedef Op<T> O;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= a.q) return;
  const T ls = *a.loglstar;
  i64 s = a.s[k];
  const i64 ph = a.phase[k];
  const bool active = s < a.n_steps;
  // the mask the eager loop applied after the likelihood call
  const T lx = a.incube[k] ? a.logl_x[k] : (T)-INFINITY, x = a.x[k];
  T l = a.left[k], r = a.right[k], fl = a.fl[k], fr = a.fr[k];
  const bool il = active && ph == PH_INIT_L, ir = active && ph == PH_INIT_R;
  const bool el = active && ph == PH_EXP_L, er = active && ph == PH_EXP_R;
  const bool sh = active && ph == PH_SHRINK;

  a.nc[k] += active;
  if (il || el) fl = lx;
  if (ir || er) fr = lx;
  if (el) l = x;
  if (er) r = x;
  const bool expanding = el || er;
  a.n_exp[k] += expanding;
  i64 es = a.exp_step[k] + expanding;
  a.n_con[k] += sh;

  const bool acc = sh && lx > ls;
  const bool rej = sh && !acc;
  if (rej && x < (T)0.0) l = x;
  if (rej && x > (T)0.0) r = x;

  // phase transitions (using the updated fl/fr)
  i64 np = il ? (i64)PH_INIT_R : ph;
  if (ir) np = fl > ls ? PH_EXP_L : (fr > ls ? PH_EXP_R : PH_SHRINK);
  if (el && lx <= ls) np = fr > ls ? PH_EXP_R : PH_SHRINK;
  if (er && lx <= ls) np = PH_SHRINK;
  if (es > 1000) *a.warn = true;

  // acceptance: record the point and enter the next slice step
  if (acc) {
    const T* up = a.upos + (i64)k * a.ndim;
    for (int d = 0; d < a.ndim; ++d) {
      a.u[(i64)k * a.ndim + d] = up[d];
      a.u0[(i64)k * a.ndim + d] = up[d];
    }
    for (int d = 0; d < a.npdim; ++d)
      a.v[(i64)k * a.npdim + d] = a.v_x[(i64)k * a.npdim + d];
    a.logl[k] = lx;
    s += 1;
    const T ur = a.u_r0[k];
    l = -ur;
    r = O::sub((T)1.0, ur);
    fl = (T)-INFINITY;
    fr = (T)-INFINITY;
    np = PH_INIT_L;
    es = 0;
  }
  a.s[k] = s;
  a.phase[k] = np;
  a.left[k] = l;
  a.right[k] = r;
  a.fl[k] = fl;
  a.fr[k] = fr;
  a.exp_step[k] = es;
  a.acc[k] = acc;
  if (s < a.n_steps) *a.any_active = true;
}

template <typename T>
int launch_propose(void* const* p, int q, int n_steps, int ndim,
                   void* stream) {
  if (q < 1 || n_steps < 1 || ndim < 1) return (int)cudaErrorInvalidValue;
  ProposeArgs<T> a{(const i64*)p[0], (const i64*)p[1], (const T*)p[2],
                   (const T*)p[3],   (const T*)p[4],   (const T*)p[5],
                   (const T*)p[6],   (const bool*)p[7], (T*)p[8],
                   (T*)p[9],         (T*)p[10],        (bool*)p[11],
                   (bool*)p[12],     q,                n_steps,
                   ndim};
  slice_propose_kernel<T><<<(q + BLOCK - 1) / BLOCK, BLOCK, 0,
                            (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_advance(void* const* p, int q, int n_steps, int ndim, int npdim,
                   void* stream) {
  if (q < 1 || n_steps < 1 || ndim < 1 || npdim < 0)
    return (int)cudaErrorInvalidValue;
  AdvanceArgs<T> a{(i64*)p[0],  (i64*)p[1],  (T*)p[2],    (T*)p[3],
                   (T*)p[4],    (T*)p[5],    (T*)p[6],    (T*)p[7],
                   (T*)p[8],    (T*)p[9],    (i64*)p[10], (i64*)p[11],
                   (i64*)p[12], (i64*)p[13], (bool*)p[14], (bool*)p[15],
                   (bool*)p[16], (const T*)p[17], (const T*)p[18],
                   (const bool*)p[19], (const T*)p[20], (const T*)p[21],
                   (const T*)p[22], (const T*)p[23], q, n_steps, ndim,
                   npdim};
  slice_advance_kernel<T><<<(q + BLOCK - 1) / BLOCK, BLOCK, 0,
                            (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// p: the tensors' pointers in the order of ProposeArgs / AdvanceArgs
#define SLICE_ENTRY(TAG, T)                                                \
  extern "C" int dynesty_slice_propose_##TAG(void* const* p, int q,        \
                                             int n_steps, int ndim,        \
                                             int unused, void* stream) {   \
    (void)unused;                                                          \
    return launch_propose<T>(p, q, n_steps, ndim, stream);                 \
  }                                                                        \
  extern "C" int dynesty_slice_advance_##TAG(void* const* p, int q,        \
                                             int n_steps, int ndim,        \
                                             int npdim, void* stream) {    \
    return launch_advance<T>(p, q, n_steps, ndim, npdim, stream);          \
  }

SLICE_ENTRY(f64, double)
SLICE_ENTRY(f32, float)
