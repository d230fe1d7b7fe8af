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
// order, on one thread block.  The kernel reads the thin-path flag itself,
// so the host never waits for it:
//   - thin path (every proposal beats every victim): the deaths are the q
//     sorted-worst live points, and the tie count of each victim is a
//     binary search in the sorted logl (torch.searchsorted's own);
//   - general path (queue mode, replay rounds, partial fills, plateaus):
//     each step needs max, min, the first-index argmin and the count of
//     points tied at the minimum of the current live logl.
//
// What bounds it on this card: latency.  A round moves well under 100 kB
// and does a few dozen operations a step; what cannot go faster is the
// chain of q dependent evidence updates, logz = logaddexp(logz, logwt),
// one float64 exp and one log1p a step on one thread (chain_probe_kernel
// times that chain alone: the round's bound).  The design keeps
// everything else off that chain.  The steps go in chunks of CHUNK, each
// with its per-step values in shared memory:
//   1. selection (warp 0): which point dies at each step, and the values
//      that do not depend on the evidence (victim, largest live logl, tie
//      count, accept, counters, the stop causes other than dlogz), up to
//      the first step such a cause stops.  Thin: a parallel prologue
//      stages the proposals, the victims and their tie counts (a binary
//      search in the sorted logl), then one thread walks the prefix
//      maximum and the counters.  General: the live logl and occupant
//      stay resident in dynamic shared memory (in global memory where
//      nlive does not fit: a layout the wrapper chooses), cut into at most
//      32 segments, lane l of the warp holding segment l's partial
//      reduction (Red); after an accepted step the warp re-reduces only
//      the segment the refill landed in and merges the 32 partials, both
//      with the hardware's warp reductions, and the maximum is kept
//      incrementally: no block barrier a step.  The argmin, its count and
//      the maximum are exact and do not depend on any order.
//   2. the terms of each selected step that the chain does not touch
//      (warp 1, behind the selection): log1p(1/n), log1p(-exp(-dlv)),
//      logaddexp(victim, loglstar).
//   3. the chain (one thread of warp 2, behind stage 2): logvol, plateau
//      entry and exit (taken inline: a plateau step's shrinkage depends on
//      logvol) and the evidence, the state in registers.
//   Stages 1-3 run at once, each publishing its progress in shared memory.
//   4. in parallel: delta_logz of every step (the first step whose
//      delta_logz falls below dlogz stops the round) and the exps of the
//      information update; then one thread runs the cheap add/multiply
//      recurrences of h and logzvar up to the first stop.
//   5. in parallel, the epilogue writes the columns.  From the first stop
//      on the state is frozen, so those steps are independent and are
//      computed in parallel from the frozen state.
// Values computed past the first stop (by stages 1-4, which run ahead of
// the dlogz test) are never written: the epilogue recomputes those steps
// from the frozen state.  A thin round is bound by stage 3, a general
// one by stage 1 (PERF.md has the stage times and the chain's bound).
//
// Rounding: the eager loop runs each operation as its own torch kernel,
// so each rounds once.  Every product and sum here is an explicit
// round-to-nearest intrinsic, which nvcc never contracts into an FMA, so
// the library needs no build flag of its own.  exp, log and log1p are
// the CUDA math library's (the functions torch's kernels call), 1/n is
// a correctly rounded division as torch's reciprocal, and logaddexp
// follows torch's CUDA kernel, equal infinities included.
// argmin breaks ties by the first index and treats NaN as smallest, max
// and min propagate NaN, as torch's reductions do.  Each step runs the
// plain loop's operations in its order: only where they run changed.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef long long i64;

namespace {

// steps a chunk holds in shared memory (and threads of the block)
constexpr int CHUNK = 256;

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

// the carried state (ops/consume.py's FLOAT_KEYS then INT_KEYS): a pointer
// to each of its 0-d tensors; plateau_mode and done are bool
struct StateIn {
  const void* p[15];
};

// the kernel's arguments, passed by value
struct Args {
  const void *live_logl, *qlogl, *sorted_logl;
  const i64 *qnc, *sort_idx;
  const bool* thin_ok;
  StateIn st;
  void *scratch, *fout, *fst_out;
  int* occ_global;
  i64 *iout, *ist_out, *path_counts;
  long long* stage_clocks;  // null, or STAGES SM clock readings
  bool *accepts, *bst_out;
  int nlive, q, batch, allow_thin, resident, seg;
  Limits lim;
};

// the stage clocks (an optional trace of the first chunk), each read by
// the thread that ends the stage: the kernel's start, the live set
// staged, the chunk's prologue, the ends of the selection, the chain-free
// terms and the chain, thread 0's part of stage 4a and its h pass, and
// the end of the round.  (A clock read just after a barrier may be
// scheduled before it, so none is taken there.)
enum Stage {
  ST_START, ST_INIT, ST_PROLOGUE, ST_SELECT, ST_TERMS, ST_CHAIN, ST_DELTA,
  ST_INFO, ST_END, STAGES
};

__device__ __forceinline__ void stamp(long long* clocks, int stage) {
  if (clocks) clocks[stage] = clock64();
}

// the state a thread carries
template <typename T>
struct State {
  T logz, logzvar, h, logvol, loglstar, pld;
  bool p_mode, done;
  i64 pc, n_acc, n_cons, nc_used, nc_accum, reason, racc;
};

// the per-step values of one chunk, in dynamic shared memory (CHUNK + 1
// entries each: the chain also stores the state entering the step after
// its last)
template <typename T>
struct Chunk {
  i64 *ncthis, *pc_in;
  T *lnew, *lmax, *lstar, *nnow, *e, *dlv, *lv, *lae, *logz_in, *logvol_in,
      *pld_in, *cur, *lhs, *logwt, *logz_new, *delta, *lzterm, *e3;
  int *worst, *src, *npl;
  unsigned char *acc, *pmode_in;
};

// the byte count of a chunk (ops/consume.py, smem_layout, mirrors it)
template <typename T>
__host__ __device__ constexpr size_t chunk_bytes() {
  return ((size_t)(CHUNK + 1) * (2 * 8 + 18 * sizeof(T) + 3 * 4 + 2) + 15) /
         16 * 16;
}

template <typename T>
__device__ Chunk<T> carve(unsigned char* base) {
  const size_t n = CHUNK + 1;
  Chunk<T> c;
  i64* pi = (i64*)base;
  c.ncthis = pi; c.pc_in = pi + n;
  T* pt = (T*)(pi + 2 * n);
  c.lnew = pt; c.lmax = pt + n; c.lstar = pt + 2 * n; c.nnow = pt + 3 * n;
  c.e = pt + 4 * n; c.dlv = pt + 5 * n; c.lv = pt + 6 * n;
  c.lae = pt + 7 * n; c.logz_in = pt + 8 * n; c.logvol_in = pt + 9 * n;
  c.pld_in = pt + 10 * n; c.cur = pt + 11 * n; c.lhs = pt + 12 * n;
  c.logwt = pt + 13 * n; c.logz_new = pt + 14 * n; c.delta = pt + 15 * n;
  c.lzterm = pt + 16 * n; c.e3 = pt + 17 * n;
  int* p32 = (int*)(pt + 18 * n);
  c.worst = p32; c.src = p32 + n; c.npl = p32 + 2 * n;
  c.acc = (unsigned char*)(p32 + 3 * n);
  c.pmode_in = c.acc + n;
  return c;
}

typedef unsigned long long u64;

// a value's place in torch.argmin's order as an unsigned key: NaN first,
// then the values in increasing order, -0 and +0 as one
__device__ __forceinline__ u64 order_key(double v) {
  if (v != v) return 0ull;
  const long long b = __double_as_longlong(__dadd_rn(v, 0.0));
  return b < 0 ? ~(u64)b : (u64)b | (1ull << 63);
}

__device__ __forceinline__ u64 order_key(float v) {
  if (v != v) return 0ull;
  const int b = __float_as_int(__fadd_rn(v, 0.0f));
  return b < 0 ? (u64)~(unsigned)b : (u64)((unsigned)b | 0x80000000u);
}

// a partial reduction of the live logl: the torch.argmin candidate (the
// smallest key, the first index among equal keys) and the count of values
// equal to it
struct Red {
  u64 key;
  int imin, cnt;
};

__device__ __forceinline__ Red red_empty() {
  return Red{~0ull, 0x7fffffff, 0};
}

__device__ __forceinline__ void merge(Red& a, u64 key, int imin, int cnt) {
  const bool eq = key == a.key;
  const bool take = key < a.key || (eq && imin < a.imin);
  a.cnt = eq ? a.cnt + cnt : (take ? cnt : a.cnt);
  if (take) {
    a.key = key;
    a.imin = imin;
  }
}

// every lane ends with the merge of the warp's 32 partials, by the
// hardware's warp reductions (the result does not depend on any order)
__device__ __forceinline__ Red warp_merge(const Red& r) {
  const unsigned full = 0xffffffffu;
  const unsigned hi = (unsigned)(r.key >> 32), lo = (unsigned)r.key;
  const unsigned mhi = __reduce_min_sync(full, hi);
  const unsigned mlo = __reduce_min_sync(full, hi == mhi ? lo : ~0u);
  const bool mine = hi == mhi && lo == mlo;
  const unsigned imin =
      __reduce_min_sync(full, mine ? (unsigned)r.imin : 0x7fffffffu);
  const unsigned cnt = __reduce_add_sync(full, mine ? (unsigned)r.cnt : 0u);
  return Red{((u64)mhi << 32) | mlo, (int)imin, (int)cnt};
}

// one segment of the live logl, reduced by one warp
template <typename T>
__device__ __forceinline__ Red reduce_segment(const T* live, int sg, int seg,
                                              int nlive, int lane) {
  Red r = red_empty();
  const int lo = sg * seg, hi = min(lo + seg, nlive);
  for (int j = lo + lane; j < hi; j += 32) merge(r, order_key(live[j]), j, 1);
  return warp_merge(r);
}


// the progress of a chunk's concurrent stages, in shared memory: steps
// selected, steps whose chain-free terms are ready, the selection's last
// step (its first stop, or n) once known, and whether it has finished
struct Progress {
  int sel, terms, kc, bits, done, kdyn, k, stopped;
};

__device__ __forceinline__ int acquire(const int* p) {
  const int v = *(const volatile int*)p;
  __threadfence_block();
  return v;
}

__device__ __forceinline__ void release(int* p, int v) {
  __threadfence_block();
  *(volatile int*)p = v;
}

// what the steps from the first stop on need: the state entering it
template <typename T>
struct Frozen {
  T loglstar, logz, logzvar, h, logvol, pld, delta, nnow, dlv, lnew;
  i64 nc_accum;
  int worst, src, kglob;
  bool p_mode, p_mode_after;
};

// the selection's counters (a copy of the carried state's)
template <typename T>
struct Sel {
  T loglstar;
  i64 n_acc, n_cons, nc_used, nc_accum, racc;
};

template <typename T>
__device__ __forceinline__ void sel_from(Sel<T>& s, const State<T>& st) {
  s.loglstar = st.loglstar;
  s.n_acc = st.n_acc; s.n_cons = st.n_cons; s.nc_used = st.nc_used;
  s.nc_accum = st.nc_accum; s.racc = st.racc;
}

// the selection publishes its steps eight at a time (a fence each time)
constexpr int PUBLISH = 8;

// the selection's last step: a stop by a cause other than dlogz at step
// j (its values are written: the chain-free terms and delta_logz need
// them), or the chunk's end
__device__ __forceinline__ void publish_end(Progress& pg, int j, int n,
                                            int bits) {
  pg.kc = j;
  pg.bits = bits;
  release(&pg.sel, min(j + 1, n));
  release(&pg.done, 1);
}

// stage 1 of the thin path (one thread): up to the first step a cause
// other than dlogz stops
template <typename T>
__device__ void select_thin(const Chunk<T>& c, Sel<T>& s, T& rmax, bool done,
                            int n, int nlive, const Limits& lim,
                            Progress& pg) {
  for (int j = 0; j < n; ++j) {
    const T v = c.lnew[j];
    c.lmax[j] = rmax;
    c.lstar[j] = s.loglstar;
    c.nnow[j] = (T)(nlive - s.racc);
    const bool c1 = s.loglstar > (T)lim.logl_max;
    const bool plat = rmax == v;
    const bool c3 = s.n_acc >= lim.max_accepts;
    const bool c4 = s.nc_used >= lim.max_nc;
    if (done || c1 || plat || c3 || c4) {
      publish_end(pg, j, n,
                  2 * (int)c1 + 4 * (int)plat + 8 * (int)c3 + 16 * (int)c4);
      return;
    }
    const i64 nc = c.ncthis[j];  // staged qnc
    c.ncthis[j] = s.nc_accum + nc;
    c.acc[j] = 1;
    if ((j + 1) % PUBLISH == 0) release(&pg.sel, j + 1);
    s.n_acc += 1;
    s.n_cons += 1;
    s.nc_used += nc;
    s.nc_accum = 0;
    s.racc += 1;
    s.loglstar = v;
    rmax = maximum(rmax, c.e[j]);
  }
  publish_end(pg, n, n, 0);
}

// stage 1 of the general path (all lanes of warp 0 in step; lane 0
// writes): ``r`` is the argmin of the current live logl, ``vmax`` its
// maximum, both kept up to date where a refill lands; lane l holds the
// partial of segment l (``mine``; at most 32 segments)
template <typename T>
__device__ void select_general(const Chunk<T>& c, Sel<T>& s, T& vmax,
                               Red& r, Red& mine, bool done, int n, int c0,
                               T* live, int* occ, int seg, int nlive,
                               int batch, const Limits& lim, int lane,
                               Progress& pg) {
  typedef Op<T> O;
  for (int j = 0; j < n; ++j) {
    const int worst = r.imin;
    const T lnew = live[worst];  // the value at the first minimum
    const int npl = lnew != lnew ? 0 : r.cnt;
    const T n_now = batch ? (T)(nlive - s.racc) : (T)nlive;
    const int src = occ[worst];
    if (lane == 0) {
      c.lnew[j] = lnew;
      c.lmax[j] = vmax;
      c.lstar[j] = s.loglstar;
      c.nnow[j] = n_now;
      c.worst[j] = worst;
      c.src[j] = src;
      c.npl[j] = npl;
    }
    const bool c1 = s.loglstar > (T)lim.logl_max;
    const bool plat = O::sub(vmax, lnew) == (T)0.0;
    const bool c3 = s.n_acc >= lim.max_accepts;
    const bool c4 = s.nc_used >= lim.max_nc;
    if (done || c1 || plat || c3 || c4) {
      if (lane == 0)
        publish_end(pg, j, n,
                    2 * (int)c1 + 4 * (int)plat + 8 * (int)c3 +
                        16 * (int)c4);
      return;
    }
    const T e = c.e[j];
    const bool accept = e > lnew;
    const i64 nc = c.ncthis[j];  // staged qnc
    const i64 nc_this = s.nc_accum + nc;
    __syncwarp();
    if (lane == 0) {
      c.ncthis[j] = nc_this;
      c.acc[j] = accept;
      if ((j + 1) % PUBLISH == 0) release(&pg.sel, j + 1);
    }
    s.n_acc += accept;
    s.n_cons += 1;
    s.nc_used += nc;
    s.nc_accum = accept ? 0 : nc_this;
    s.racc += accept;
    if (accept) {
      // the live maximum can only rise, to the refill (torch.max's value;
      // a NaN maximum stays, and a NaN proposal is never accepted)
      s.loglstar = lnew;
      if (e > vmax) vmax = e;
      if (lane == 0) {
        live[worst] = e;
        occ[worst] = c0 + j;
      }
      __syncwarp();
      const int sg = worst / seg;
      const Red p = reduce_segment(live, sg, seg, nlive, lane);
      if (lane == sg) mine = p;
      r = warp_merge(mine);
    }
  }
  if (lane == 0) publish_end(pg, n, n, 0);
}

// stage 2 (one warp, behind the selection): the terms of each selected
// step that the chain does not touch
template <typename T>
__device__ void chain_free_terms(const Chunk<T>& c, int batch, bool thin,
                                 const Limits& lim, int lane, Progress& pg) {
  typedef Op<T> O;
  int j0 = 0;
  while (true) {
    // lane 0 reads the selection's progress for the warp, so that its
    // lanes stay in step
    int done = 0, avail = 0;
    if (lane == 0) {
      done = acquire(&pg.done);
      avail = acquire(&pg.sel);
    }
    done = __shfl_sync(0xffffffffu, done, 0);
    avail = __shfl_sync(0xffffffffu, avail, 0);
    if (avail > j0) {
      const int cnt = min(avail - j0, 32);
      if (lane < cnt) {
        const int j = j0 + lane;
        const T d = batch || thin ? O::log1p_(O::div((T)1.0, c.nnow[j]))
                                  : (T)lim.dlv_default;
        c.dlv[j] = d;
        c.lv[j] = O::log1p_(-O::exp_(-d));
        c.lae[j] = logaddexp(c.lnew[j], c.lstar[j]);
      }
      __syncwarp();
      j0 += cnt;
      if (lane == 0) release(&pg.terms, j0);
    } else if (done) {
      return;
    }
  }
}

// stage 3 (one thread, behind stage 2): logvol, plateau mode and the
// evidence, the state in registers; stores the state entering each step
// and the step after its last
template <typename T>
__device__ void chain(const Chunk<T>& c, const State<T>& st, int n,
                      Progress& pg) {
  typedef Op<T> O;
  const T ln_half = (T)(-0x1.62e42fefa39efp-1);  // math.log(0.5)
  T logz = st.logz, logvol = st.logvol, pld = st.pld;
  bool pm = st.p_mode;
  i64 pc = st.pc;
  int j = 0, ready = 0, kc = 0x7fffffff;
  for (; j < n; ++j) {
    if (j >= ready) {
      // wait for step j's terms; the selection's stop, if it has one, is
      // known by the time they are
      do {
        ready = acquire(&pg.terms);
      } while (ready <= j);
      kc = acquire(&pg.kc);
    }
    if (j >= kc) break;
    const int npl = c.npl[j];
    const bool acc = c.acc[j];
    T cur = c.dlv[j], lv = c.lv[j];
    const T lae = c.lae[j];
    c.logz_in[j] = logz;
    c.logvol_in[j] = logvol;
    c.pld_in[j] = pld;
    c.pmode_in[j] = pm;
    c.pc_in[j] = pc;
    if (!pm && npl > 1) {
      pc = npl;
      pld = O::add(-O::log_(O::add(c.nnow[j], (T)1.0)), logvol);
      pm = true;
    }
    if (pm) {
      cur = -O::log1p_(-O::exp_(O::sub(pld, logvol)));
      lv = O::log1p_(-O::exp_(-cur));
    }
    const T logvol_new = O::sub(logvol, cur);
    const T lhs = O::add(O::add(O::add(logvol_new, cur), ln_half), lv);
    const T logwt = O::add(lae, lhs);
    const T logz_new = logaddexp(logz, logwt);
    c.cur[j] = cur;
    c.lhs[j] = lhs;
    c.logwt[j] = logwt;
    c.logz_new[j] = logz_new;
    if (acc) {
      logz = logz_new;
      logvol = logvol_new;
    }
    if (acc && pm) pc -= 1;
    pm = pm && pc != 0;
  }
  c.logz_in[j] = logz;
  c.logvol_in[j] = logvol;
  c.pld_in[j] = pld;
  c.pmode_in[j] = pm;
  c.pc_in[j] = pc;
}

// a block barrier reached by whole warps: a lane that was busy in a role
// of its own (the thin selection, the chain, the h pass) holds its warp's
// other lanes at the __syncwarp, so that every warp arrives converged
__device__ __forceinline__ void block_sync() {
  __syncwarp();
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(CHUNK)
consume_scan_kernel(Args a) {
  typedef Op<T> O;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Progress pg;
  __shared__ State<T> ss;  // the carried state, between chunks
  __shared__ Frozen<T> fz;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int nlive = a.nlive, q = a.q, seg = a.seg;
  const int nseg = (nlive + seg - 1) / seg;
  const Limits lim = a.lim;
  const bool thin = a.allow_thin && *a.thin_ok;
  const T* live_logl = (const T*)a.live_logl;
  const T* qlogl = (const T*)a.qlogl;
  const T* sorted_logl = (const T*)a.sorted_logl;
  T* fout = (T*)a.fout;
  const T zero = (T)0.0;

  long long* const clocks = a.stage_clocks;
  if (tid == 0) stamp(clocks, ST_START);
  const Chunk<T> c = carve<T>(smem);
  Red* part = (Red*)(smem + chunk_bytes<T>());
  unsigned char* resident =
      smem + chunk_bytes<T>() + ((size_t)nseg * sizeof(Red) + 15) / 16 * 16;
  T* live = a.resident ? (T*)resident : (T*)a.scratch;
  int* occ = a.resident ? (int*)(resident + (size_t)nlive * sizeof(T))
                        : a.occ_global;

  if (tid == 0) {
    const void* const* p = a.st.p;
    ss.logz = *(const T*)p[0]; ss.logzvar = *(const T*)p[1];
    ss.h = *(const T*)p[2]; ss.logvol = *(const T*)p[3];
    ss.loglstar = *(const T*)p[4]; ss.pld = *(const T*)p[5];
    ss.p_mode = *(const bool*)p[6]; ss.pc = *(const i64*)p[7];
    ss.n_acc = *(const i64*)p[8]; ss.n_cons = *(const i64*)p[9];
    ss.nc_used = *(const i64*)p[10]; ss.nc_accum = *(const i64*)p[11];
    ss.done = *(const bool*)p[12]; ss.reason = *(const i64*)p[13];
    ss.racc = *(const i64*)p[14];
    pg.stopped = 0;
  }

  // the general path: the live logl, its segments' partials, its argmin
  // and maximum (warp 0's registers); the thin path: the largest live
  // logl (thread 0's)
  Red r, mine;
  Sel<T> start;  // the chunk's starting counters (thread 0)
  T vmax = thin ? sorted_logl[nlive - 1] : (T)-INFINITY;
  if (!thin) {
    for (int j = tid; j < nlive; j += blockDim.x) {
      live[j] = live_logl[j];
      occ[j] = -1;
    }
    block_sync();
    for (int sg = warp; sg < nseg; sg += nwarps) {
      const Red p = reduce_segment(live, sg, seg, nlive, lane);
      if (lane == 0) part[sg] = p;
    }
    if (warp == 0) {
      for (int j = lane; j < nlive; j += 32) vmax = maximum(vmax, live[j]);
      for (int off = 16; off > 0; off >>= 1)
        vmax = maximum(vmax, __shfl_xor_sync(0xffffffffu, vmax, off));
    }
  }
  block_sync();
  if (!thin && warp == 0) {
    mine = lane < nseg ? part[lane] : red_empty();
    r = warp_merge(mine);
  }
  if (tid == 0) stamp(clocks, ST_INIT);

  for (int c0 = 0; c0 < q; c0 += CHUNK) {
    const int n = min(CHUNK, q - c0);
    const bool frozen = pg.stopped;
    if (!frozen) {
      // the chunk's proposals and, on the thin path, its victims and
      // their tie counts
      for (int j = tid; j < n; j += blockDim.x) {
        const int i = c0 + j;
        c.e[j] = qlogl[i];
        c.ncthis[j] = a.qnc[i];
        if (thin) {
          // torch.searchsorted(sorted_logl, v, right=True) - i
          const T v = sorted_logl[i];
          int lo = 0, hi = nlive;
          while (lo < hi) {
            const int mid = lo + ((hi - lo) >> 1);
            if (!(sorted_logl[mid] > v)) lo = mid + 1; else hi = mid;
          }
          c.lnew[j] = v;
          c.npl[j] = lo - i;
        }
      }
      if (tid == 0) {
        pg.sel = pg.terms = pg.done = 0;
        pg.kc = 0x7fffffff;
        pg.kdyn = n;
      }
      block_sync();
      long long* const trace = c0 == 0 ? clocks : nullptr;
      if (tid == 0) stamp(trace, ST_PROLOGUE);

      // stages 1-3 at once: the selection (warp 0), the chain-free terms
      // (warp 1) and the chain (warp 2), each behind the one before
      if (warp == 0) {
        Sel<T> sel;
        sel_from(sel, ss);
        start = sel;
        if (thin) {
          if (lane == 0) {
            select_thin(c, sel, vmax, ss.done, n, nlive, lim, pg);
            stamp(trace, ST_SELECT);
            // the state entering the next chunk, if nothing stops here
            ss.loglstar = sel.loglstar; ss.n_acc = sel.n_acc;
            ss.n_cons = sel.n_cons; ss.nc_used = sel.nc_used;
            ss.nc_accum = sel.nc_accum; ss.racc = sel.racc;
          }
        } else {
          const State<T> st = ss;
          __syncwarp();
          select_general(c, sel, vmax, r, mine, st.done, n, c0, live, occ,
                         seg, nlive, a.batch, lim, lane, pg);
          if (lane == 0) {
            stamp(trace, ST_SELECT);
            ss.loglstar = sel.loglstar; ss.n_acc = sel.n_acc;
            ss.n_cons = sel.n_cons; ss.nc_used = sel.nc_used;
            ss.nc_accum = sel.nc_accum; ss.racc = sel.racc;
          }
        }
      } else if (warp == 1) {
        chain_free_terms(c, a.batch, thin, lim, lane, pg);
        if (lane == 0) stamp(trace, ST_TERMS);
      } else if (warp == 2 && lane == 0) {
        chain(c, ss, n, pg);
        stamp(trace, ST_CHAIN);
      }
      block_sync();
      const int kc = pg.kc, nb = min(kc + 1, n);

      // 4a. delta_logz and the first dlogz stop; the information's exps
      for (int j = tid; j < nb; j += blockDim.x) {
        const T d = logaddexp(
            zero, O::sub(O::add(c.lmax[j], c.logvol_in[j]), c.logz_in[j]));
        c.delta[j] = d;
        if (d < (T)lim.dlogz) atomicMin(&pg.kdyn, j);
        if (j < kc) {
          const T ls = c.lstar[j], ln = c.lnew[j], lz = c.logz_new[j],
                  lh = c.lhs[j];
          c.lzterm[j] = O::add(O::mul(O::exp_(O::add(O::sub(ls, lz), lh)), ls),
                               O::mul(O::exp_(O::add(O::sub(ln, lz), lh)), ln));
          c.e3[j] = O::exp_(O::sub(c.logz_in[j], lz));
        }
      }
      block_sync();

      // 4b. h and logzvar up to the first stop, the state entering it
      if (tid == 0) {
        stamp(trace, ST_DELTA);
        const int k = min(pg.kdyn, kc);
        T h = ss.h, logzvar = ss.logzvar;
#pragma unroll 4
        for (int j = 0; j < k; ++j) {
          const T h_new = O::sub(
              O::add(c.lzterm[j], O::mul(c.e3[j], O::add(h, c.logz_in[j]))),
              c.logz_new[j]);
          const T logzvar_new =
              O::add(logzvar, O::mul(O::sub(h_new, h), c.cur[j]));
          fout[4 * q + c0 + j] = logzvar_new;
          fout[5 * q + c0 + j] = h_new;
          if (c.acc[j]) {
            h = h_new;
            logzvar = logzvar_new;
          }
        }
        ss.h = h;
        ss.logzvar = logzvar;
        ss.logz = c.logz_in[k];
        ss.logvol = c.logvol_in[k];
        ss.pld = c.pld_in[k];
        ss.p_mode = c.pmode_in[k];
        ss.pc = c.pc_in[k];
        if (k < n) {
          // a stop at step k: the counters entering it (the selection ran
          // ahead), from the chunk's start
          Sel<T> s = start;
          for (int j = 0; j < k; ++j) {
            const bool acc = c.acc[j];
            s.n_acc += acc;
            s.n_cons += 1;
            s.nc_used += a.qnc[c0 + j];
            s.nc_accum = acc ? 0 : c.ncthis[j];
            s.racc += acc;
          }
          ss.loglstar = c.lstar[k];
          ss.n_acc = s.n_acc; ss.n_cons = s.n_cons; ss.nc_used = s.nc_used;
          ss.nc_accum = s.nc_accum; ss.racc = s.racc;
          const bool c0_ = c.delta[k] < (T)lim.dlogz;
          if (!ss.done) ss.reason = (i64)c0_ + (k == kc ? pg.bits : 0);
          ss.done = true;
          fz.loglstar = ss.loglstar; fz.logz = ss.logz;
          fz.logzvar = ss.logzvar; fz.h = ss.h; fz.logvol = ss.logvol;
          fz.pld = ss.pld; fz.delta = c.delta[k]; fz.nnow = c.nnow[k];
          fz.dlv = c.dlv[k]; fz.lnew = c.lnew[k];
          fz.nc_accum = ss.nc_accum;
          fz.worst = thin ? 0 : c.worst[k];
          fz.src = thin ? -1 : c.src[k];
          fz.kglob = c0 + k;
          fz.p_mode = ss.p_mode;
          ss.p_mode = ss.p_mode && ss.pc != 0;
          fz.p_mode_after = ss.p_mode;
          pg.stopped = 1;
        }
        pg.k = k;
        stamp(trace, ST_INFO);
      }
      block_sync();
    }

    // 5. the columns; from the first stop on, from the frozen state
    const int k = frozen ? 0 : pg.k;
    for (int j = tid; j < n; j += blockDim.x) {
      const int i = c0 + j;
      if (j < k) {
        fout[0 * q + i] = c.lnew[j];
        fout[1 * q + i] = O::sub(c.logvol_in[j], c.cur[j]);
        fout[2 * q + i] = c.logwt[j];
        fout[3 * q + i] = c.logz_new[j];
        fout[6 * q + i] = c.delta[j];
        fout[7 * q + i] = c.nnow[j];
        a.iout[i] = thin ? a.sort_idx[i] : (i64)c.worst[j];
        a.iout[q + i] = thin ? -1 : (i64)c.src[j];
        a.iout[2 * q + i] = c.ncthis[j];
        a.accepts[i] = c.acc[j];
      } else {
        const T v = thin ? sorted_logl[i] : fz.lnew;
        const bool pm = i == fz.kglob ? fz.p_mode : fz.p_mode_after;
        const T cur = pm ? -O::log1p_(-O::exp_(O::sub(fz.pld, fz.logvol)))
                         : fz.dlv;
        const T logvol_new = O::sub(fz.logvol, cur);
        T logwt, logz_new, logzvar_new, h_new;
        integrate(fz.loglstar, v, fz.logz, fz.logzvar, logvol_new, cur, fz.h,
                  &logwt, &logz_new, &logzvar_new, &h_new);
        fout[0 * q + i] = v;
        fout[1 * q + i] = logvol_new;
        fout[2 * q + i] = logwt;
        fout[3 * q + i] = logz_new;
        fout[4 * q + i] = logzvar_new;
        fout[5 * q + i] = h_new;
        fout[6 * q + i] = fz.delta;
        fout[7 * q + i] = fz.nnow;
        a.iout[i] = thin ? a.sort_idx[i] : (i64)fz.worst;
        a.iout[q + i] = thin ? -1 : (i64)fz.src;
        a.iout[2 * q + i] = fz.nc_accum;
        a.accepts[i] = false;
      }
    }
    block_sync();
  }

  if (tid != 0) return;
  T* fst = (T*)a.fst_out;
  fst[0] = ss.logz; fst[1] = ss.logzvar; fst[2] = ss.h;
  fst[3] = ss.logvol; fst[4] = ss.loglstar; fst[5] = ss.pld;
  i64* ist = a.ist_out;
  ist[0] = ss.p_mode; ist[1] = ss.pc; ist[2] = ss.n_acc;
  ist[3] = ss.n_cons; ist[4] = ss.nc_used; ist[5] = ss.nc_accum;
  ist[6] = ss.done; ist[7] = ss.reason; ist[8] = ss.racc;
  a.bst_out[0] = ss.p_mode;
  a.bst_out[1] = ss.done;
  a.path_counts[thin ? 0 : 1] += 1;
  stamp(clocks, ST_END);
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

// the chain's critical path alone, for its bound: the q dependent steps
// logz = logaddexp(logz, logwt[j]) from logz0 on one thread, the logwt
// of a round staged in shared memory, run ``reps`` times in series (each
// pass starts from logz0 plus a zero that depends on the last pass's end)
template <typename T>
__global__ void chain_probe_kernel(const T* logwt, const T* logz0, T* out,
                                   int q, int reps) {
  typedef Op<T> O;
  __shared__ T w[CHUNK];
  for (int j = threadIdx.x; j < q; j += blockDim.x) w[j] = logwt[j];
  __syncthreads();
  if (threadIdx.x != 0) return;
  const T z0 = *logz0;
  T start = z0, logz = z0;
  for (int r = 0; r < reps; ++r) {
    logz = start;
    for (int j = 0; j < q; ++j) logz = logaddexp(logz, w[j]);
    start = O::add(z0, O::sub(logz, logz));
  }
  out[0] = logz;
}

int set_smem(const void* fn, int bytes) {
  // the largest dynamic shared memory the kernel was allowed, per device
  static int allowed[64][2];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  const int slot = fn == (const void*)consume_scan_kernel<double> ? 0 : 1;
  if (bytes > 48 * 1024 && bytes > allowed[dev][slot]) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) {
      cudaGetLastError();  // not left for the next launch's check
      return (int)err;
    }
    allowed[dev][slot] = bytes;
  }
  return 0;
}

template <typename T>
int launch_scan(const void* live_logl, const void* qlogl, const void* qnc,
                const void* sort_idx, const void* sorted_logl,
                const void* thin_ok, const void* const* state_in,
                void* scratch, void* occupant, void* fout, void* iout,
                void* accepts, void* fst_out, void* ist_out, void* bst_out,
                void* path_counts, void* stage_clocks, int nlive, int q,
                int batch,
                int allow_thin, int resident, int seg, int smem_bytes,
                double dlogz, double logl_max, i64 max_accepts, i64 max_nc,
                double dlv_default, int block, void* stream) {
  const size_t nseg = seg > 0 ? ((size_t)nlive + seg - 1) / seg : 0;
  const size_t need = chunk_bytes<T>() +
                      (nseg * sizeof(Red) + 15) / 16 * 16 +
                      (resident ? (size_t)nlive * (sizeof(T) + 4) : 0);
  if (block != CHUNK || nlive < 1 || q < 1 || seg < 32 || seg % 32 != 0 ||
      nseg > 32 ||
      smem_bytes < 0 || (size_t)smem_bytes < need ||
      (!resident && (!scratch || !occupant)) ||
      (allow_thin && (!sort_idx || !sorted_logl || !thin_ok)))
    return (int)cudaErrorInvalidValue;
  const void* fn = (const void*)consume_scan_kernel<T>;
  int err = set_smem(fn, smem_bytes);
  if (err != 0) return err;
  Args a;
  a.live_logl = live_logl; a.qlogl = qlogl; a.sorted_logl = sorted_logl;
  a.qnc = (const i64*)qnc; a.sort_idx = (const i64*)sort_idx;
  a.thin_ok = (const bool*)thin_ok;
  for (int k = 0; k < 15; ++k) a.st.p[k] = state_in[k];
  a.scratch = scratch; a.fout = fout; a.fst_out = fst_out;
  a.occ_global = (int*)occupant;
  a.iout = (i64*)iout; a.ist_out = (i64*)ist_out;
  a.path_counts = (i64*)path_counts;
  a.stage_clocks = (long long*)stage_clocks;
  a.accepts = (bool*)accepts; a.bst_out = (bool*)bst_out;
  a.nlive = nlive; a.q = q; a.batch = batch; a.allow_thin = allow_thin;
  a.resident = resident; a.seg = seg;
  a.lim = Limits{dlogz, logl_max, dlv_default, max_accepts, max_nc};
  consume_scan_kernel<T><<<1, CHUNK, smem_bytes, (cudaStream_t)stream>>>(a);
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

template <typename T>
int launch_chain_probe(const void* logwt, const void* logz0, void* out,
                       int q, int reps, void* stream) {
  if (q < 1 || q > CHUNK || reps < 1) return (int)cudaErrorInvalidValue;
  chain_probe_kernel<T><<<1, CHUNK, 0, (cudaStream_t)stream>>>(
      (const T*)logwt, (const T*)logz0, (T*)out, q, reps);
  return (int)cudaGetLastError();
}

}  // namespace

#define SCAN_ENTRY(TAG, T)                                                   \
  extern "C" int dynesty_consume_scan_##TAG(                                 \
      const void* live_logl, const void* qlogl, const void* qnc,             \
      const void* sort_idx, const void* sorted_logl, const void* thin_ok,    \
      const void* const* state_in, void* scratch, void* occupant,            \
      void* fout, void* iout, void* accepts, void* fst_out, void* ist_out,   \
      void* bst_out, void* path_counts, void* stage_clocks, int nlive,       \
      int q, int batch, int allow_thin, int resident, int seg,               \
      int smem_bytes, double dlogz, double logl_max, i64 max_accepts,        \
      i64 max_nc, double dlv_default, int block, void* stream) {             \
    return launch_scan<T>(live_logl, qlogl, qnc, sort_idx, sorted_logl,      \
                          thin_ok, state_in, scratch, occupant, fout, iout,  \
                          accepts, fst_out, ist_out, bst_out, path_counts,   \
                          stage_clocks, nlive, q, batch, allow_thin,         \
                          resident, seg, smem_bytes, dlogz, logl_max,        \
                          max_accepts, max_nc, dlv_default, block, stream);  \
  }                                                                          \
  extern "C" int dynesty_consume_integrator_##TAG(                           \
      const void* a, const void* b, const void* c, const void* d,            \
      const void* e, const void* f, const void* g, void* logwt, void* logz,  \
      void* logzvar, void* h, int n, void* stream) {                         \
    return launch_integrator<T>(a, b, c, d, e, f, g, logwt, logz, logzvar,   \
                                h, n, stream);                               \
  }                                                                          \
  extern "C" int dynesty_consume_chain_probe_##TAG(                          \
      const void* logwt, const void* logz0, void* out, int q, int reps,      \
      void* stream) {                                                        \
    return launch_chain_probe<T>(logwt, logz0, out, q, reps, stream);        \
  }

SCAN_ENTRY(f64, double)
SCAN_ENTRY(f32, float)
