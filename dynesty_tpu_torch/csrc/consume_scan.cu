// The consume scan of one fused nested-sampling round, for Hopper (sm_90a).
//
// Replaces the JAX package's lax.scan inside every fused round:
// dynesty_tpu/internal/fused.py:212 (the general body), :333 (the thin
// body) and :423 (the lax.cond that picks one), which XLA runs as a loop
// on the device.  The port's eager loop over 0-d tensors
// (dynesty_tpu_torch/ops/consume.py, consume_round_plain) stays as the
// plain version this kernel is held against bit for bit.
//
// One launch consumes one round: q proposals against the live set, in
// order, on one thread block.  Thread 0 carries the integrator and counter
// state through the q steps.  The kernel reads the thin-path flag itself,
// so the host never waits for it:
//   - thin path (every proposal beats every victim): the deaths are the q
//     sorted-worst live points, so each step is a scalar recurrence on
//     thread 0 over the sorted victims (sort and tie counts come in from
//     torch, as they sit outside the scan in the JAX package);
//   - general path (queue mode, replay rounds, partial fills, plateaus):
//     each step needs max, min, the first-index argmin and the count of
//     points tied at the minimum of the current live logl: one block-wide
//     reduction pass over nlive values, then thread 0 takes the step and
//     writes the refill into a scratch copy of the live logl.
//
// What bounds it on this card: a chain of q dependent steps, each a few
// float64 transcendentals and, on the general path, one reduction over
// nlive values with two barriers.  That is latency, not bytes (a round
// moves well under 100 kB) nor operations.  A simple, right kernel is the
// aim here; keeping the live logl resident in shared memory, warp-level
// tricks and incremental maxima are left for later.
//
// Rounding: the eager loop runs each operation as its own torch kernel,
// so each rounds once.  Every product and sum here is an explicit
// round-to-nearest intrinsic, which nvcc never contracts into an FMA, so
// the library needs no build flag of its own.  exp, log and log1p are
// the CUDA math library's (the functions torch's kernels call), 1/n is
// a correctly rounded division as torch's reciprocal, and logaddexp
// follows torch's CUDA kernel, equal infinities included.
// argmin breaks ties by the first index and treats NaN as smallest, max
// and min propagate NaN, as torch's reductions do.

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
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double exp_(double a) { return exp(a); }
  static __device__ __forceinline__ double log_(double a) { return log(a); }
  static __device__ __forceinline__ double log1p_(double a) { return log1p(a); }
  static __device__ __forceinline__ double abs_(double a) { return fabs(a); }
  static __device__ __forceinline__ double max_(double a, double b) { return fmax(a, b); }
};

template <> struct Op<float> {
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float exp_(float a) { return expf(a); }
  static __device__ __forceinline__ float log_(float a) { return logf(a); }
  static __device__ __forceinline__ float log1p_(float a) { return log1pf(a); }
  static __device__ __forceinline__ float abs_(float a) { return fabsf(a); }
  static __device__ __forceinline__ float max_(float a, float b) { return fmaxf(a, b); }
};

// torch.logaddexp's CUDA kernel
template <typename T>
__device__ __forceinline__ T logaddexp(T a, T b) {
  typedef Op<T> O;
  if (isinf(a) && a == b) return a;
  T m = O::max_(a, b);
  return O::add(m, O::log1p_(O::exp_(-O::abs_(O::sub(a, b)))));
}

// torch.maximum (NaN propagates)
template <typename T>
__device__ __forceinline__ T maximum(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return Op<T>::max_(a, b);
}

// progress_integration_torch (dynesty_tpu_torch/ops/integrals.py), the
// same operations in the same order
template <typename T>
__device__ __forceinline__ void integrate(T loglstar, T loglstar_new, T logz,
                                          T logzvar, T logvol, T dlogvol,
                                          T h, T* logwt_o, T* logz_o,
                                          T* logzvar_o, T* h_o) {
  typedef Op<T> O;
  const T ln_half = (T)(-0x1.62e42fefa39efp-1);  // math.log(0.5)
  T lhs = O::add(O::add(O::add(logvol, dlogvol), ln_half),
                 O::log1p_(-O::exp_(-dlogvol)));
  T logwt = O::add(logaddexp(loglstar_new, loglstar), lhs);
  T logz_new = logaddexp(logz, logwt);
  T lzterm = O::add(
      O::mul(O::exp_(O::add(O::sub(loglstar, logz_new), lhs)), loglstar),
      O::mul(O::exp_(O::add(O::sub(loglstar_new, logz_new), lhs)),
             loglstar_new));
  T h_new = O::sub(O::add(lzterm, O::mul(O::exp_(O::sub(logz, logz_new)),
                                         O::add(h, logz))),
                   logz_new);
  *logwt_o = logwt;
  *logz_o = logz_new;
  *logzvar_o = O::add(logzvar, O::mul(O::sub(h_new, h), dlogvol));
  *h_o = h_new;
}

struct Limits {
  double dlogz, logl_max, dlv_default;
  i64 max_accepts, max_nc;
};

// the carried state of the scan (held by thread 0)
template <typename T>
struct State {
  T logz, logzvar, h, logvol, loglstar, pld;
  bool p_mode, done;
  i64 pc, n_acc, n_cons, nc_used, nc_accum, reason, racc;
};

// the stop tests of one step (_causes / _stop): reason is set at the first
// stop only, done is sticky
template <typename T>
__device__ __forceinline__ void stop_tests(State<T>& s, T delta_logz,
                                           bool plateau, const Limits& lim) {
  bool c0 = delta_logz < (T)lim.dlogz;
  bool c1 = s.loglstar > (T)lim.logl_max;
  bool c3 = s.n_acc >= lim.max_accepts;
  bool c4 = s.nc_used >= lim.max_nc;
  bool stop = c0 || c1 || plateau || c3 || c4;
  if (stop && !s.done)
    s.reason = (i64)c0 + 2 * (i64)c1 + 4 * (i64)plateau + 8 * (i64)c3 +
               16 * (i64)c4;
  s.done = s.done || stop;
}

// one death at loglstar_new (_kill): plateau entry and exit, the
// shrinkage, the evidence update and the counters, applied where accept;
// writes the step's record values
template <typename T>
__device__ __forceinline__ void kill_step(State<T>& s, T loglstar_new,
                                          i64 npl, T n_now, T dlv_now,
                                          bool accept, bool consumed,
                                          i64 e_nc, int i, int q, T* fout,
                                          i64* nc_out) {
  typedef Op<T> O;
  bool enter = !s.p_mode && npl > 1 && !s.done;
  if (enter) {
    s.pc = npl;
    s.pld = O::add(-O::log_(O::add(n_now, (T)1.0)), s.logvol);
  }
  s.p_mode = s.p_mode || enter;
  T cur_dlv = s.p_mode ? -O::log1p_(-O::exp_(O::sub(s.pld, s.logvol)))
                       : dlv_now;
  i64 nc_entry = consumed ? e_nc : 0;
  i64 nc_this = s.nc_accum + nc_entry;
  T logvol_new = O::sub(s.logvol, cur_dlv);
  T logwt, logz_new, logzvar_new, h_new;
  integrate(s.loglstar, loglstar_new, s.logz, s.logzvar, logvol_new, cur_dlv,
            s.h, &logwt, &logz_new, &logzvar_new, &h_new);
  if (accept) {
    s.logz = logz_new;
    s.logzvar = logzvar_new;
    s.h = h_new;
    s.logvol = logvol_new;
    s.loglstar = loglstar_new;
  }
  s.n_acc += accept;
  s.n_cons += consumed;
  s.nc_used += nc_entry;
  s.nc_accum = accept ? 0 : nc_this;
  if (accept && s.p_mode) s.pc -= 1;
  s.p_mode = s.p_mode && !(s.p_mode && s.pc == 0);
  s.racc += accept;
  fout[0 * q + i] = loglstar_new;
  fout[1 * q + i] = logvol_new;
  fout[2 * q + i] = logwt;
  fout[3 * q + i] = logz_new;
  fout[4 * q + i] = logzvar_new;
  fout[5 * q + i] = h_new;
  *nc_out = nc_this;
}

// a partial reduction of the live logl: the NaN-propagating maximum, and
// the torch.argmin candidate (NaN smallest, first index on ties) with the
// count of values equal to it
template <typename T>
struct Red {
  T vmax, vmin;
  int imin, cnt;
};

template <typename T>
__device__ __forceinline__ void merge(Red<T>& a, const Red<T>& b) {
  if (b.vmax != b.vmax || b.vmax > a.vmax) a.vmax = b.vmax;
  bool an = a.vmin != a.vmin, bn = b.vmin != b.vmin;
  if (!an && !bn && a.vmin == b.vmin) {
    a.cnt += b.cnt;
    if (b.imin < a.imin) {
      a.vmin = b.vmin;
      a.imin = b.imin;
    }
  } else if (an ? (bn && b.imin < a.imin) : (bn || b.vmin < a.vmin)) {
    a = Red<T>{a.vmax, b.vmin, b.imin, b.cnt};
  }
}

template <typename T>
__device__ __forceinline__ void warp_merge(Red<T>& r) {
  for (int off = 16; off > 0; off >>= 1) {
    Red<T> o;
    o.vmax = __shfl_down_sync(0xffffffffu, r.vmax, off);
    o.vmin = __shfl_down_sync(0xffffffffu, r.vmin, off);
    o.imin = __shfl_down_sync(0xffffffffu, r.imin, off);
    o.cnt = __shfl_down_sync(0xffffffffu, r.cnt, off);
    merge(r, o);
  }
}

template <typename T>
__global__ void consume_scan_kernel(
    const T* __restrict__ live_logl, const T* __restrict__ qlogl,
    const i64* __restrict__ qnc, const i64* __restrict__ sort_idx,
    const T* __restrict__ sorted_logl, const i64* __restrict__ npl_pre,
    const bool* __restrict__ thin_ok, const T* __restrict__ fst,
    const i64* __restrict__ ist, T* scratch, i64* occupant, T* fout,
    i64* iout, bool* accepts, T* fst_out, i64* ist_out, i64* path_counts,
    int nlive, int q, int batch, int allow_thin, Limits lim) {
  typedef Op<T> O;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const bool thin = allow_thin && *thin_ok;
  State<T> s;
  if (tid == 0) {
    s.logz = fst[0]; s.logzvar = fst[1]; s.h = fst[2];
    s.logvol = fst[3]; s.loglstar = fst[4]; s.pld = fst[5];
    s.p_mode = ist[0] != 0; s.pc = ist[1]; s.n_acc = ist[2];
    s.n_cons = ist[3]; s.nc_used = ist[4]; s.nc_accum = ist[5];
    s.done = ist[6] != 0; s.reason = ist[7]; s.racc = ist[8];
  }
  const T zero = (T)0.0;

  if (thin) {
    if (tid != 0) return;
    T rmax = sorted_logl[nlive - 1];
    for (int i = 0; i < q; ++i) {
      T e_logl = qlogl[i], v_logl = sorted_logl[i];
      T n_now = (T)(nlive - s.racc);
      T delta_logz = logaddexp(zero, O::sub(O::add(rmax, s.logvol), s.logz));
      stop_tests(s, delta_logz, rmax == v_logl, lim);
      bool accept = !s.done;
      const T dlv_now = O::log1p_(O::div((T)1.0, n_now));
      kill_step(s, v_logl, npl_pre[i], n_now, dlv_now, accept, accept, qnc[i],
                i, q, fout, &iout[2 * q + i]);
      if (accept) rmax = maximum(rmax, e_logl);
      fout[6 * q + i] = delta_logz;
      fout[7 * q + i] = n_now;
      iout[i] = sort_idx[i];
      iout[q + i] = -1;
      accepts[i] = accept;
    }
  } else {
    __shared__ Red<T> part[32];
    for (int j = tid; j < nlive; j += blockDim.x) {
      scratch[j] = live_logl[j];
      occupant[j] = -1;
    }
    __syncthreads();
    for (int i = 0; i < q; ++i) {
      Red<T> r{-INFINITY, INFINITY, 0x7fffffff, 0};
      for (int j = tid; j < nlive; j += blockDim.x) {
        T v = scratch[j];
        merge(r, Red<T>{v, v, j, 1});
      }
      warp_merge(r);
      if (lane == 0) part[warp] = r;
      __syncthreads();
      if (warp == 0) {
        r = lane < nwarps ? part[lane]
                          : Red<T>{-INFINITY, INFINITY, 0x7fffffff, 0};
        warp_merge(r);
        if (lane == 0) {
          T e_logl = qlogl[i];
          T n_now = batch ? (T)(nlive - s.racc) : (T)nlive;
          T lmax = r.vmax;
          T delta_logz =
              logaddexp(zero, O::sub(O::add(lmax, s.logvol), s.logz));
          stop_tests(s, delta_logz, O::sub(lmax, r.vmin) == zero, lim);
          const int worst = r.imin;
          const T lnew = r.vmin;  // the value at the first minimal index
          const i64 npl = lnew != lnew ? 0 : r.cnt;
          T dlv_now = batch ? O::log1p_(O::div((T)1.0, n_now))
                            : (T)lim.dlv_default;
          bool accept = !s.done && e_logl > lnew;
          kill_step(s, lnew, npl, n_now, dlv_now, accept, !s.done, qnc[i],
                    i, q, fout, &iout[2 * q + i]);
          const i64 src = occupant[worst];
          scratch[worst] = accept ? e_logl : lnew;
          occupant[worst] = accept ? (i64)i : src;
          fout[6 * q + i] = delta_logz;
          fout[7 * q + i] = n_now;
          iout[i] = worst;
          iout[q + i] = src;
          accepts[i] = accept;
        }
      }
      __syncthreads();
    }
    if (tid != 0) return;
  }
  fst_out[0] = s.logz; fst_out[1] = s.logzvar; fst_out[2] = s.h;
  fst_out[3] = s.logvol; fst_out[4] = s.loglstar; fst_out[5] = s.pld;
  ist_out[0] = s.p_mode; ist_out[1] = s.pc; ist_out[2] = s.n_acc;
  ist_out[3] = s.n_cons; ist_out[4] = s.nc_used; ist_out[5] = s.nc_accum;
  ist_out[6] = s.done; ist_out[7] = s.reason; ist_out[8] = s.racc;
  path_counts[thin ? 0 : 1] += 1;
}

template <typename T>
__global__ void integrator_kernel(const T* a, const T* b, const T* c,
                                  const T* d, const T* e, const T* f,
                                  const T* g, T* logwt, T* logz, T* logzvar,
                                  T* h, int n) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < n)
    integrate(a[k], b[k], c[k], d[k], e[k], f[k], g[k], &logwt[k], &logz[k],
              &logzvar[k], &h[k]);
}

template <typename T>
int launch_scan(const void* live_logl, const void* qlogl, const void* qnc,
                const void* sort_idx, const void* sorted_logl,
                const void* npl_pre, const void* thin_ok, const void* fst,
                const void* ist, void* scratch, void* occupant, void* fout,
                void* iout, void* accepts, void* fst_out, void* ist_out,
                void* path_counts, int nlive, int q, int batch,
                int allow_thin, double dlogz, double logl_max,
                i64 max_accepts, i64 max_nc, double dlv_default, int block,
                void* stream) {
  if (block < 32 || block > 1024 || block % 32 != 0 || nlive < 1 || q < 1 ||
      (allow_thin && (!sort_idx || !sorted_logl || !npl_pre || !thin_ok)))
    return (int)cudaErrorInvalidValue;
  Limits lim{dlogz, logl_max, dlv_default, max_accepts, max_nc};
  consume_scan_kernel<T><<<1, block, 0, (cudaStream_t)stream>>>(
      (const T*)live_logl, (const T*)qlogl, (const i64*)qnc,
      (const i64*)sort_idx, (const T*)sorted_logl, (const i64*)npl_pre,
      (const bool*)thin_ok, (const T*)fst, (const i64*)ist, (T*)scratch,
      (i64*)occupant, (T*)fout, (i64*)iout, (bool*)accepts, (T*)fst_out,
      (i64*)ist_out, (i64*)path_counts, nlive, q, batch, allow_thin, lim);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_integrator(const void* a, const void* b, const void* c,
                      const void* d, const void* e, const void* f,
                      const void* g, void* logwt, void* logz, void* logzvar,
                      void* h, int n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  integrator_kernel<T><<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const T*)a, (const T*)b, (const T*)c, (const T*)d, (const T*)e,
      (const T*)f, (const T*)g, (T*)logwt, (T*)logz, (T*)logzvar, (T*)h, n);
  return (int)cudaGetLastError();
}

}  // namespace

#define SCAN_ENTRY(TAG, T)                                                   \
  extern "C" int dynesty_consume_scan_##TAG(                                 \
      const void* live_logl, const void* qlogl, const void* qnc,             \
      const void* sort_idx, const void* sorted_logl, const void* npl_pre,    \
      const void* thin_ok, const void* fst, const void* ist, void* scratch,  \
      void* occupant, void* fout, void* iout, void* accepts, void* fst_out,  \
      void* ist_out, void* path_counts, int nlive, int q, int batch,         \
      int allow_thin, double dlogz, double logl_max, i64 max_accepts,        \
      i64 max_nc, double dlv_default, int block, void* stream) {             \
    return launch_scan<T>(live_logl, qlogl, qnc, sort_idx, sorted_logl,      \
                          npl_pre, thin_ok, fst, ist, scratch, occupant,     \
                          fout, iout, accepts, fst_out, ist_out,             \
                          path_counts, nlive, q, batch, allow_thin, dlogz,   \
                          logl_max, max_accepts, max_nc, dlv_default, block, \
                          stream);                                           \
  }                                                                          \
  extern "C" int dynesty_consume_integrator_##TAG(                           \
      const void* a, const void* b, const void* c, const void* d,            \
      const void* e, const void* f, const void* g, void* logwt, void* logz,  \
      void* logzvar, void* h, int n, void* stream) {                         \
    return launch_integrator<T>(a, b, c, d, e, f, g, logwt, logz, logzvar,   \
                                h, n, stream);                               \
  }

SCAN_ENTRY(f64, double)
SCAN_ENTRY(f32, float)
