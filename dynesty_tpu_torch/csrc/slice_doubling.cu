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
//   doubling_point: the step's two end probes (its interval (-r0, 1 - r0),
//     the step's capped direction and start point taken into the round's
//     buffers; behind a set round gate no lane counts): the point
//     u0 + x * direction, its cube check with the lane's mask, and the
//     point clamped into the cube (where the likelihood is evaluated).
//   doubling_expand: after the end probes, the step's initial state; after
//     a doubling, one side of each active lane's interval doubled (the side
//     its probe kept), its end value, the evaluations, the expansion tally
//     (grow clamped at 2^30), and whether the lane still expands.  Then
//     each lane's next probe from the vectors drawn just before it: the
//     next doubling's new end where the lane doubles on (its side kept in
//     go_left, its cube check in incube), else the first shrink
//     candidate l + r * (right - left) (x1, its point u_c, its cube check
//     in incube_s); and the `any` flag (does a lane double on), cleared and
//     raised in this one launch.
//   doubling_halve: one halving of the acceptance test for the lanes whose
//     candidate is above the threshold: the sides, the divergence flag, the
//     rejection, the evaluations; then the next halving's probe (its mid
//     0.5 * (lhat + rhat), the point, its cube check with the lanes that
//     halve on, the point clamped) and the `any` flag, in one block.
//   doubling_shrink: a shrink candidate's outcome before the halvings (its
//     logl, whether it is above the threshold, the test's start and the
//     first halving's probe), and its resolution after them (the test's
//     verdict and evaluations, the lane's point where it accepts, the
//     shrunk interval where it rejects, and there the next candidate's
//     probe from the vector drawn just before it).
//
// What bounds it on this card: nothing the card measures.  A call moves a
// few values a lane and a row of ndim values (~20 kB at q 256, ndim 3:
// ~0.006 us at 3.35 TB/s); a launch costs ~0.8 us of latency and each
// chain of dependent trips to memory ~1,000 SM cycles, and the host's
// Python around it tens of us.  The design answer is to take the host
// out of each loop turn: the round's buffers and the argument tables are
// made once per round shape, the clamp and the -inf mask (once torch ops
// around the likelihood) are folded in here, each kernel takes only device
// pointers, and where the likelihood runs on the card each segment of the
// round between two host reads -- the step's start, a doubling, a shrink
// candidate, a halving, a shrink's resolution: the draws, these kernels,
// the batched likelihood, the blob's copy or select and the flag's copy to
// pinned host memory -- is captured once as a CUDA graph and replayed, as
// the JAX package traces its loop bodies once.  Then the launches in a
// segment: every probe but the step's two end probes reads only what the
// kernel before it wrote and the next uniform vector of the round's
// stream, so that kernel writes it (doubling_expand the next doubling's or
// the first candidate's, a resolution the next candidate's, a candidate's
// doubling_shrink or a halving the next halving's), with the vector drawn
// before it: a doubling segment is the likelihood, the draw and
// doubling_expand, a candidate segment the likelihood and doubling_shrink;
// the round gate is read in the end probes' kernel, not applied by torch
// ops after it.  A lane's next probe is one of two kinds (a lane that
// doubles on, a lane that shrinks), so each kind has its own cube check:
// the host learns only from the flag which segment comes next.
// doubling_point, doubling_expand and doubling_shrink run one thread per
// (lane, dimension), so that a warp's loads and stores are neighbouring
// addresses (a lane's cube check is an AND over its threads, as in
// rwalk_step.cu); doubling_halve, one block that must also write the
// flag, one thread per four dimensions of a lane (one a lane up to four
// dimensions), so that up to 1,024 lanes take one pass (its first design,
// a thread per (lane, dimension), took 2.8 us at (256, 3) on 1,024
// threads; this one ~2.2 us on 256).  doubling_expand keeps the grid: each
// block ORs its lanes' votes and adds itself to a count beside the votes
// in one 64-bit atomic, and the last block to add writes the flag and
// zeroes the word for the next launch (the blocks of a launch run in no
// order, so no block may clear what another raised).  Each kernel issues
// every load of a lane at once (one trip to memory; doubling_point's step
// start reads its direction's row by the step, a second) and writes the
// lane's values after the group's vote, which orders its threads' loads
// before them.

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

// doubling_point's modes (ops/proposals.py, P_*): the step's end probes;
// every other probe is written by the kernel before it
enum { P_START_L = 0, P_START_R = 1 };
// doubling_expand's and doubling_shrink's (X_*, S_*)
enum { X_INIT = 0, X_DOUBLE = 1 };
enum { S_CANDIDATE = 0, S_RESOLVE = 1 };

const int BLOCK = 128;
// the threads of doubling_halve's one block
const int HALVE_BLOCK = 1024;
const unsigned FULL = 0xffffffffu;

// A lane's cube check over its group of `width` threads (a power of two
// <= 32, or a multiple of 32): the AND of their votes.  Every thread of a
// warp calls it, and past 32 threads a lane every thread of the block
// (two barriers, `warp_all` one entry a warp).
__device__ __forceinline__ bool group_all(bool in, int width,
                                          int* warp_all) {
  const int t = threadIdx.x;
  if (width <= 32) {
    const unsigned vote = __ballot_sync(FULL, in);
    const unsigned group =
        width == 32 ? FULL : ((1u << width) - 1u) << ((t & 31) & ~(width - 1));
    return (vote & group) == group;
  }
  const bool w = __all_sync(FULL, in);
  if ((t & 31) == 0) warp_all[t >> 5] = w;
  __syncthreads();
  const int nw = width >> 5, first = (t / width) * nw;
  bool all = true;
  for (int i = 0; i < nw; ++i) all = all && warp_all[first + i] != 0;
  __syncthreads();
  return all;
}

// The thread's first H elements of a lane's start and direction rows and
// of the cube check's mask (the dimensions sub, sub + width, ...), loaded
// with the lane's values: where width * H >= ndim a thread has no other,
// so a kernel's loads are one trip to memory.  doubling_point and
// doubling_shrink take one (a thread per lane and dimension up to 128),
// doubling_halve HEAD (fewer threads a lane, for more lanes a pass).
const int HEAD = 4;

template <typename T, int H>
struct RowHead {
  T base[H], dir[H];
  bool tight[H];
};

template <typename T, int H>
__device__ __forceinline__ void head_dirs(RowHead<T, H>& h, const T* dir,
                                          int ndim, int sub, int width) {
#pragma unroll
  for (int r = 0; r < H; ++r) {
    const int d = sub + r * width;
    h.dir[r] = d < ndim ? dir[d] : (T)0.0;
  }
}

template <typename T, int H>
__device__ __forceinline__ RowHead<T, H> row_head(
    const T* u0, const T* dir, const bool* strict, int ndim, int sub,
    int width, bool dirs = true) {
  RowHead<T, H> h;
#pragma unroll
  for (int r = 0; r < H; ++r) {
    const int d = sub + r * width;
    h.base[r] = d < ndim ? u0[d] : (T)0.0;
    h.tight[r] = d >= ndim || strict == nullptr || strict[d];
  }
  if (dirs) head_dirs(h, dir, ndim, sub, width);
  return h;
}

// The point u0 + x * dir at one dimension: written clamped into `uclamp`
// (torch's clamp: NaN passes, else min(max(p, 0), 1)) and, where `u_c` is
// given, as it is; where `u0_out` is given, the start and direction
// copied there (the step's start).  Returns whether it is in the cube
// (loosely where the dimension is not bounded).
template <typename T>
__device__ __forceinline__ bool probe_one(T base, T dd, bool tight, T x,
                                          int d, T* uclamp, T* u_c,
                                          T* u0_out, T* dir_out) {
  typedef Op<T> O;
  const T p = O::add(base, O::mul(x, dd));
  if (u0_out != nullptr) {
    u0_out[d] = base;
    dir_out[d] = dd;
  }
  if (u_c != nullptr) u_c[d] = p;
  uclamp[d] = isnan(p) ? p : fmin(fmax(p, (T)0.0), (T)1.0);
  return tight ? (p > (T)0.0 && p < (T)1.0) : (p > (T)-0.5 && p < (T)1.5);
}

// The thread's share of a lane's point (the dimensions sub, sub + width,
// ...): the first H from its loaded head, the others (only where
// width * H < ndim) loaded here.  Returns whether they are in the cube.
template <typename T, int H>
__device__ __forceinline__ bool probe_row(
    const RowHead<T, H>& h, const T* u0, const T* dir, const bool* strict,
    T* uclamp, T* u_c, T* u0_out, T* dir_out, T x, int ndim, int sub,
    int width) {
  bool in = true;
#pragma unroll
  for (int r = 0; r < H; ++r) {
    const int d = sub + r * width;
    if (d < ndim)
      in = probe_one(h.base[r], h.dir[r], h.tight[r], x, d, uclamp, u_c,
                     u0_out, dir_out) && in;
  }
  for (int d = sub + H * width; d < ndim; d += width)
    in = probe_one(u0[d], dir[d], strict == nullptr || strict[d], x, d,
                   uclamp, u_c, u0_out, dir_out) && in;
  return in;
}

template <typename T>
struct PointArgs {
  i64* step;            // the step whose direction the start takes
  const T* dirs;        // (q, n_steps, ndim), lengths capped
  T* dir;               // (q, ndim): the step's direction
  const T* u;           // (q, ndim): the lanes' points
  T* u0;                // (q, ndim): the step's start points
  const T* draw;        // (q,): r0
  T* left;              // the doubling's interval
  T* right;
  const bool* gate;     // the round gate: set, the end probes count no lane
  const bool* strict;   // (ndim,) or null: all strict
  T* uclamp;            // the point clamped into [0, 1], NaN kept
  bool* incube;         // the right end probe's cube check
  bool* incube_l;       // the left end probe's cube check
  int q, ndim, n_steps, mode;
};

// One thread per (lane, dimension): a lane is a group of `width` threads
// (a power of two <= 32, or a multiple of 32 that loops over the
// dimensions past it), `lanes` groups a block.  The lane's position is
// computed by each of its threads; its first thread writes the lane's
// values.  Every load a mode needs is issued at once: the lane's draw or
// right end, the gate, the step index, and the direction and start rows
// (P_START_L's direction row, indexed by the step, is the one second
// trip).
template <typename T>
__global__ void __launch_bounds__(BLOCK) doubling_point_kernel(
    PointArgs<T> a, int width, int lanes) {
  typedef Op<T> O;
  __shared__ int warp_all[BLOCK / 32];
  const int t = threadIdx.x;
  const int g = t / width, sub = t - g * width;
  const int k = blockIdx.x * lanes + g;
  const bool live = k < a.q;
  const bool start = a.mode == P_START_L;

  T x = (T)0.0, l = (T)0.0, r = (T)0.0;
  bool mask = true, in = true;
  if (live) {
    const i64 row = (i64)k * a.ndim;
    // the step's start is the lane's point; the direction's row is
    // indexed by the step, the one second trip
    const T* base = start ? a.u + row : a.u0 + row;
    const T* dir = a.dir + row;
    RowHead<T, 1> h = row_head<T, 1>(base, dir, a.strict, a.ndim, sub,
                                     width, !start);
    mask = !*a.gate;
    if (start) {
      const i64 s = *a.step;
      const T r0 = a.draw[k];
      // the step index clamped to the last step, as a round never passes
      // it
      const i64 step = s < a.n_steps - 1 ? s : a.n_steps - 1;
      l = -r0;
      r = O::sub((T)1.0, r0);
      x = l;
      dir = a.dirs + ((i64)k * a.n_steps + step) * a.ndim;
      head_dirs(h, dir, a.ndim, sub, width);
    } else {
      x = a.right[k];
    }
    in = probe_row(h, base, dir, a.strict, a.uclamp + row, (T*)nullptr,
                   start ? a.u0 + row : (T*)nullptr,
                   start ? a.dir + row : (T*)nullptr, x, a.ndim, sub, width);
  }
  // the cube check: AND over the lane's threads (threads past q vote true)
  const bool all_in = group_all(in, width, warp_all);
  if (sub != 0 || !live) return;
  if (start) {
    a.incube_l[k] = all_in && mask;
    a.left[k] = l;
    a.right[k] = r;
  } else {
    a.incube[k] = all_in && mask;
  }
}

// The grid's OR of the threads' `mine`, written to `flag` by the block
// that finishes last, in the launch that votes: each block's thread 0 adds
// one to the count (the low 32 bits of `vote`) and its block's OR to the
// votes (the high 32) in one atomic, and the block that brings the count
// to the grid's size writes the flag and zeroes the word, which is zero
// between launches.  Every thread of the block calls it.
__device__ __forceinline__ void grid_any(bool mine, bool* flag,
                                         unsigned long long* vote) {
  const bool any = __syncthreads_or(mine) != 0;
  if (threadIdx.x != 0) return;
  const unsigned long long add = 1ull + (any ? 1ull << 32 : 0ull);
  const unsigned long long old = atomicAdd(vote, add);
  if ((unsigned)(old & 0xffffffffull) == gridDim.x - 1) {
    *flag = ((old + add) >> 32) != 0;
    atomicExch(vote, 0ull);
  }
}

template <typename T>
struct ExpandArgs {
  const bool* incube_l;  // the left end probe's cube check (X_INIT)
  bool* incube;          // the probe's cube check; then the next doubling's
  const T* logl_l;       // the left end probe's raw values (X_INIT)
  const T* logl_x;       // the likelihood's raw values, masked here
  const T* draw;         // the next doubling's side
  const T* draw_x;       // the first shrink candidate's position
  const T* loglstar;
  T* left;
  T* right;
  T* fl;
  T* fr;
  T* sl;
  T* sr;
  bool* active;
  bool* s_active;
  bool* go_left;         // the side of the lane's doubling
  i64* grow;
  i64* nc;
  i64* n_exp;
  i64* step;
  const T* u0;           // (q, ndim): the step's start points
  const T* dir;          // (q, ndim): the step's direction
  const bool* strict;    // (ndim,) or null: all strict
  T* uclamp;             // (q, ndim): the next probe's point, clamped
  T* u_c;                // (q, ndim): the shrink candidate's point
  T* x1;                 // the shrink candidate's position
  bool* incube_s;        // the shrink candidate's cube check
  bool* any;             // a flag: does any lane double on
  unsigned long long* vote;
  int q, ndim, mode;
};

// Lanes in groups of `width` threads as doubling_point's.  Every thread
// of a lane loads the lane's values with its elements of the start and
// direction rows, applies the end probes (X_INIT) or the doubling
// (X_DOUBLE, on the side its probe kept) and computes the lane's next
// position: the new end of the next doubling where the lane doubles on
// (the side from `draw`), else the first shrink candidate (from
// `draw_x`), on the interval just updated; then its dimensions of the
// point.  After the group's vote its first thread writes the lane's
// values, and the blocks vote the flag (grid_any).
template <typename T>
__global__ void __launch_bounds__(BLOCK) doubling_expand_kernel(
    ExpandArgs<T> a, int width, int lanes) {
  typedef Op<T> O;
  __shared__ int warp_all[BLOCK / 32];
  const int t = threadIdx.x;
  const int g = t / width, sub = t - g * width;
  const int k = blockIdx.x * lanes + g;
  const bool live = k < a.q;
  const bool init = a.mode == X_INIT;
  bool in = true, act = false, a0 = false, s_act = true, side = false;
  T l = (T)0.0, r = (T)0.0, fl = (T)0.0, fr = (T)0.0, x = (T)0.0;
  i64 grow = 0, nc = 0, n_exp = 0, step = 0;
  if (live) {
    const i64 row = (i64)k * a.ndim;
    const RowHead<T, 1> hd = row_head<T, 1>(
        a.u0 + row, a.dir + row, a.strict, a.ndim, sub, width);
    // every load of the lane at once, each by its own address: no value
    // loaded decides whether another is loaded (the step index too, which
    // lane 0 advances at the step's start)
    if (init && k == 0) step = *a.step;
    const T ls = *a.loglstar;
    const bool inc = a.incube[k];
    const T lx0 = a.logl_x[k];
    l = a.left[k];
    r = a.right[k];
    const T ds = a.draw[k], dx = a.draw_x[k];
    nc = a.nc[k];
    const T lx = inc ? lx0 : (T)-INFINITY;
    if (init) {
      const bool inc_l = a.incube_l[k];
      const T ll0 = a.logl_l[k];
      fl = inc_l ? ll0 : (T)-INFINITY;
      fr = lx;
      act = fl > ls || fr > ls;
    } else {
      a0 = a.active[k];
      const bool gl = a.go_left[k];
      const T fl0 = a.fl[k], fr0 = a.fr[k];
      grow = a.grow[k];
      n_exp = a.n_exp[k];
      s_act = a.s_active[k];
      const T w = O::sub(r, l);
      if (a0 && gl) l = O::sub(l, w);
      if (a0 && !gl) r = O::add(r, w);
      fl = (a0 && gl) ? lx : fl0;
      fr = (a0 && !gl) ? lx : fr0;
      act = a0 && (fl > ls || fr > ls);
    }
    // the next probe: the doubling's new end on the side drawn, or the
    // shrink candidate (its point kept as u_c)
    side = ds < (T)0.5;
    if (act) {
      const T w = O::sub(r, l);
      x = side ? O::sub(l, w) : O::add(r, w);
    } else {
      x = O::add(l, O::mul(dx, O::sub(r, l)));
    }
    in = probe_row(hd, a.u0 + row, a.dir + row, a.strict, a.uclamp + row,
                   act ? (T*)nullptr : a.u_c + row, (T*)nullptr,
                   (T*)nullptr, x, a.ndim, sub, width);
  }
  // the vote orders every thread's loads of its lane before the lane's
  // first thread writes it
  const bool all_in = group_all(in, width, warp_all);
  if (live && sub == 0) {
    a.fl[k] = fl;
    a.fr[k] = fr;
    a.sl[k] = l;
    a.sr[k] = r;
    a.active[k] = act;
    if (init) {
      a.nc[k] = nc + 2;
      a.grow[k] = 1;
      a.s_active[k] = true;
      if (k == 0) *a.step = step + 1;
    } else {
      a.left[k] = l;
      a.right[k] = r;
      if (a0) {
        a.nc[k] = nc + 1;
        a.n_exp[k] = n_exp + grow;
        a.grow[k] = grow * 2 < ((i64)1 << 30) ? grow * 2 : ((i64)1 << 30);
      }
    }
    if (act) {
      a.go_left[k] = side;
      a.incube[k] = all_in;
      a.incube_s[k] = false;
    } else {
      a.x1[k] = x;
      a.incube[k] = false;
      a.incube_s[k] = all_in && s_act;
    }
  }
  grid_any(live && sub == 0 && act, a.any, a.vote);
}

template <typename T>
struct HalveArgs {
  bool* incube;         // the mid's cube check; then the next mid's
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
  const T* u0;          // (q, ndim): the step's start points
  const T* dir;         // (q, ndim): the step's direction
  const bool* strict;   // (ndim,) or null: all strict
  T* uclamp;            // (q, ndim): the next mid's point, clamped
  int q, ndim;
};

// One halving and the next halving's probe, in one block: the lanes in
// groups of `width` threads as doubling_point's, `lanes` groups a pass,
// passes until every lane is done.  The lane's values are loaded by each
// of its threads at once with its start and direction rows; its first
// thread writes the lane's values.  The `any` flag (does a lane halve on)
// is the block's OR, written once by thread 0 after the last pass: no
// other block, and no zeroing launch before it.
template <typename T>
__global__ void __launch_bounds__(HALVE_BLOCK) doubling_halve_kernel(
    HalveArgs<T> a, int width, int lanes) {
  typedef Op<T> O;
  __shared__ int warp_all[HALVE_BLOCK / 32];
  const int t = threadIdx.x;
  const int g = t / width, sub = t - g * width;
  const T ls = *a.loglstar;
  bool mine = false;
  for (int base = 0; base < a.q; base += lanes) {
    const int k = base + g;
    const bool live = k < a.q;
    bool in = true, still = false, newly = false, df = false, act = false;
    T lh = (T)0.0, rh = (T)0.0, flh = (T)0.0, frh = (T)0.0;
    i64 dnc = 0;
    if (live) {
      const i64 row = (i64)k * a.ndim;
      const RowHead<T, HEAD> hd = row_head<T, HEAD>(
          a.u0 + row, a.dir + row, a.strict, a.ndim, sub, width);
      const T x1 = a.x1[k];
      lh = a.lhat[k];
      rh = a.rhat[k];
      flh = a.f_lhat[k];
      frh = a.f_rhat[k];
      act = a.h_active[k];
      const bool df0 = a.dflag[k], inc = a.incube[k];
      const T lx = a.logl_x[k];
      dnc = a.d_nc[k];
      const T mid = O::mul((T)0.5, O::add(lh, rh));
      df = df0 || ((T)0.0 < mid && mid <= x1) || (x1 < mid && mid <= (T)0.0);
      const bool go_right = x1 < mid;  // shrink the right side toward x1
      const T lm = inc ? lx : (T)-INFINITY;
      if (act && go_right) {
        frh = lm;
        rh = mid;
      }
      if (act && !go_right) {
        flh = lm;
        lh = mid;
      }
      newly = act && df && ls >= flh && ls >= frh;
      still = act && !newly && O::sub(rh, lh) > (T)1.1;
      // the next halving's mid, probed as doubling_point's P_HALVE was
      const T next = O::mul((T)0.5, O::add(lh, rh));
      in = probe_row(hd, a.u0 + row, a.dir + row, a.strict, a.uclamp + row,
                     (T*)nullptr, (T*)nullptr, (T*)nullptr, next, a.ndim,
                     sub, width);
    }
    // the vote orders every thread's loads of its lane before the lane's
    // first thread writes it
    const bool all_in = group_all(in, width, warp_all);
    if (live && sub == 0) {
      a.d_nc[k] = dnc + act;
      a.lhat[k] = lh;
      a.rhat[k] = rh;
      a.f_lhat[k] = flh;
      a.f_rhat[k] = frh;
      a.dflag[k] = df;
      if (newly) a.reject[k] = true;
      a.h_active[k] = still;
      a.incube[k] = all_in && still;
      mine = mine || still;
    }
  }
  const bool any = __syncthreads_or(mine) != 0;
  if (t == 0) *a.any = any;
}

template <typename T>
struct ShrinkArgs {
  bool* incube_s;       // the candidate's cube check (S_CANDIDATE); the
                        // next candidate's (S_RESOLVE)
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
  T* u_c;               // (q, ndim): the candidate's point; the next's
  T* x1;                // the candidate's position; the next's
  T* sl;
  T* sr;
  bool* newly;          // the lanes that accept (the blob's select)
  bool* any;            // a flag: does any lane run the halving test
  bool* any_shrink;     // a flag: does any lane shrink on
  const T* u0;          // (q, ndim): the step's start points
  const T* dir;         // (q, ndim): the step's direction
  const bool* strict;   // (ndim,) or null: all strict
  T* uclamp;            // (q, ndim): the next probe's point, clamped
  bool* incube;         // the first halving's cube check (S_CANDIDATE)
  const T* draw;        // the next candidate's draw (S_RESOLVE)
  int q, ndim, npdim, mode;
};

// Lanes in groups of `width` threads as doubling_point's.  S_CANDIDATE
// also probes the first halving's mid (as doubling_point's P_HALVE was):
// its point clamped into `uclamp` and its cube check with the lanes that
// start the test.  The likelihood's v_x may be `uclamp` itself (an
// identity prior transform returns its input): each thread reads its
// elements of the v_x row before it writes the same elements of the
// probe's row, and the probe's row of a lane is written by the lane's
// own threads only, so no element is overwritten before it is read.
// S_RESOLVE also probes the next candidate (as doubling_point's P_SHRINK
// was: every lane, its cube check with the lanes that shrink on), on the
// shrunk interval, from `draw`: each thread reads its elements of the
// candidate's row before it writes the same elements of the next one's,
// and x1 is read by every thread of the lane before its first thread
// writes it.
template <typename T>
__global__ void __launch_bounds__(BLOCK) doubling_shrink_kernel(
    ShrinkArgs<T> a, int width, int lanes) {
  typedef Op<T> O;
  __shared__ int warp_all[BLOCK / 32];
  const int t = threadIdx.x;
  const int g = t / width, sub = t - g * width;
  const int k = blockIdx.x * lanes + g;
  const bool live = k < a.q;
  const T ls = *a.loglstar;
  if (a.mode == S_CANDIDATE) {
    bool in = true, h = false, good = false, act = false;
    T l = (T)0.0, r = (T)0.0, fl = (T)0.0, fr = (T)0.0, lx = (T)0.0;
    i64 nc = 0, ncon = 0;
    if (live) {
      const i64 vrow = (i64)k * a.npdim, row = (i64)k * a.ndim;
      const RowHead<T, 1> hd = row_head<T, 1>(
          a.u0 + row, a.dir + row, a.strict, a.ndim, sub, width);
      // the candidate's v, read before the probe's row is written (v_x
      // may be uclamp)
      const T v0 = sub < a.npdim ? a.v_x[vrow + sub] : (T)0.0;
      const bool inc = a.incube_s[k];
      act = a.s_active[k];
      const T lx0 = a.logl_x[k];
      l = a.left[k];
      r = a.right[k];
      fl = a.fl[k];
      fr = a.fr[k];
      nc = a.nc[k];
      ncon = a.n_con[k];
      if (sub < a.npdim) a.v_c[vrow + sub] = v0;
      for (int d = sub + width; d < a.npdim; d += width)
        a.v_c[vrow + d] = a.v_x[vrow + d];
      lx = inc ? lx0 : (T)-INFINITY;
      good = lx > ls;
      // the acceptance test's start on the doubling's interval
      h = O::sub(r, l) > (T)1.1 && act && good;
      in = probe_row(hd, a.u0 + row, a.dir + row, a.strict, a.uclamp + row,
                     (T*)nullptr, (T*)nullptr, (T*)nullptr,
                     O::mul((T)0.5, O::add(l, r)), a.ndim, sub, width);
    }
    // the vote orders every thread's loads of its lane before the lane's
    // first thread writes it
    const bool all_in = group_all(in, width, warp_all);
    if (blockIdx.x == 0 && t == 0) *a.any_shrink = false;
    if (!live || sub != 0) return;
    a.logl_c[k] = lx;
    a.nc[k] = nc + act;
    a.n_con[k] = ncon + act;
    a.good[k] = good;
    a.h_active[k] = h;
    a.incube[k] = all_in && h;
    a.lhat[k] = l;
    a.rhat[k] = r;
    a.f_lhat[k] = fl;
    a.f_rhat[k] = fr;
    a.dflag[k] = false;
    a.reject[k] = false;
    a.d_nc[k] = 0;
    // `any` is false on entry: the loop before a candidate ended on it
    if (h) *a.any = true;
    return;
  }
  // S_RESOLVE
  bool act = false, good0 = false, newly = false, bad = false, in = true;
  T x = (T)0.0, l = (T)0.0, r = (T)0.0, xn = (T)0.0, lc = (T)0.0;
  i64 dnc = 0, nc = 0;
  if (live) {
    // the candidate's rows loaded with the lane's values, kept where it
    // accepts
    const i64 row = (i64)k * a.ndim, vrow = (i64)k * a.npdim;
    const RowHead<T, 1> hd = row_head<T, 1>(
        a.u0 + row, a.dir + row, a.strict, a.ndim, sub, width);
    const T u1 = sub < a.ndim ? a.u_c[row + sub] : (T)0.0;
    const T v1 = sub < a.npdim ? a.v_c[vrow + sub] : (T)0.0;
    act = a.s_active[k];
    good0 = a.good[k];
    const bool rej = a.reject[k];
    x = a.x1[k];
    dnc = a.d_nc[k];
    nc = a.nc[k];
    lc = a.logl_c[k];
    l = a.sl[k];
    r = a.sr[k];
    const T dr = a.draw[k];
    newly = act && good0 && !rej;
    bad = act && !newly;
    if (newly) {
      if (sub < a.ndim) a.u[row + sub] = u1;
      if (sub < a.npdim) a.v[vrow + sub] = v1;
      for (int d = sub + width; d < a.ndim; d += width)
        a.u[row + d] = a.u_c[row + d];
      for (int d = sub + width; d < a.npdim; d += width)
        a.v[vrow + d] = a.v_c[vrow + d];
    }
    if (bad && x < (T)0.0) l = x;
    if (bad && x > (T)0.0) r = x;
    // the next candidate on the interval, shrunk where the lane shrinks
    // on, its point kept as u_c (every lane, as P_SHRINK probed it)
    xn = O::add(l, O::mul(dr, O::sub(r, l)));
    in = probe_row(hd, a.u0 + row, a.dir + row, a.strict, a.uclamp + row,
                   a.u_c + row, (T*)nullptr, (T*)nullptr, xn, a.ndim, sub,
                   width);
  }
  // the vote orders the lane's threads' loads before its writes
  const bool all_in = group_all(in, width, warp_all);
  if (!live || sub != 0) return;
  if (act && good0) a.nc[k] = nc + dnc;
  if (newly) a.logl[k] = lc;
  if (bad && x < (T)0.0) a.sl[k] = x;
  if (bad && x > (T)0.0) a.sr[k] = x;
  a.s_active[k] = bad;
  a.newly[k] = newly;
  a.x1[k] = xn;
  a.incube_s[k] = all_in && bad;
  if (bad) *a.any_shrink = true;
}

// threads a lane for doubling_point, doubling_halve and doubling_shrink
int lane_width(int ndim) {
  if (ndim > 32) return ndim >= BLOCK ? BLOCK : (ndim + 31) / 32 * 32;
  int w = 1;
  while (w < ndim) w *= 2;
  return w;
}

// threads a lane for doubling_halve: a power of two up to a warp, each
// thread HEAD dimensions (and a loop past them beyond 128)
int halve_width(int ndim) {
  int w = 1;
  while (w * HEAD < ndim && w < 32) w *= 2;
  return w;
}

template <typename T>
int launch_point(void* const* p, int q, int ndim, int n_steps, int mode,
                 void* stream) {
  if (q < 1 || ndim < 1 || n_steps < 1 ||
      (mode != P_START_L && mode != P_START_R) || !p[8])
    return (int)cudaErrorInvalidValue;
  PointArgs<T> a{(i64*)p[0],        (const T*)p[1],    (T*)p[2],
                 (const T*)p[3],    (T*)p[4],          (const T*)p[5],
                 (T*)p[6],          (T*)p[7],          (const bool*)p[8],
                 (const bool*)p[9], (T*)p[10],         (bool*)p[11],
                 (bool*)p[12],      q,                 ndim,
                 n_steps,           mode};
  const int width = lane_width(ndim), lanes = BLOCK / width;
  doubling_point_kernel<T><<<(q + lanes - 1) / lanes, lanes * width, 0,
                             (cudaStream_t)stream>>>(a, width, lanes);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_expand(void* const* p, int q, int ndim, int mode, void* stream) {
  if (q < 1 || ndim < 1 || (mode != X_INIT && mode != X_DOUBLE) || !p[3] ||
      !p[5] || !p[28] || (mode == X_INIT && !p[2]))
    return (int)cudaErrorInvalidValue;
  ExpandArgs<T> a{(const bool*)p[0],  (bool*)p[1],    (const T*)p[2],
                  (const T*)p[3],     (const T*)p[4], (const T*)p[5],
                  (const T*)p[6],     (T*)p[7],       (T*)p[8],
                  (T*)p[9],           (T*)p[10],      (T*)p[11],
                  (T*)p[12],          (bool*)p[13],   (bool*)p[14],
                  (bool*)p[15],       (i64*)p[16],    (i64*)p[17],
                  (i64*)p[18],        (i64*)p[19],    (const T*)p[20],
                  (const T*)p[21],    (const bool*)p[22], (T*)p[23],
                  (T*)p[24],          (T*)p[25],      (bool*)p[26],
                  (bool*)p[27],       (unsigned long long*)p[28], q,
                  ndim,               mode};
  const int width = lane_width(ndim), lanes = BLOCK / width;
  doubling_expand_kernel<T><<<(q + lanes - 1) / lanes, lanes * width, 0,
                              (cudaStream_t)stream>>>(a, width, lanes);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_halve(void* const* p, int q, int ndim, void* stream) {
  if (q < 1 || ndim < 1 || !p[1]) return (int)cudaErrorInvalidValue;
  HalveArgs<T> a{(bool*)p[0],        (const T*)p[1],  (const T*)p[2],
                 (const T*)p[3],     (T*)p[4],        (T*)p[5],
                 (T*)p[6],           (T*)p[7],        (bool*)p[8],
                 (bool*)p[9],        (bool*)p[10],    (i64*)p[11],
                 (bool*)p[12],       (const T*)p[13], (const T*)p[14],
                 (const bool*)p[15], (T*)p[16],       q,
                 ndim};
  // one block: as many lanes a pass as fit (each thread HEAD dimensions
  // of its lane, so a lane's threads are fewer than the other kernels'),
  // the threads a whole number of warps
  const int width = halve_width(ndim);
  const int most = HALVE_BLOCK / width;
  const int want = (q < most ? q : most) * width;
  const int threads = (want + 31) / 32 * 32;
  doubling_halve_kernel<T><<<1, threads, 0, (cudaStream_t)stream>>>(
      a, width, threads / width);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_shrink(void* const* p, int q, int ndim, int npdim, int mode,
                  void* stream) {
  if (q < 1 || ndim < 1 || npdim < 0 ||
      (mode != S_CANDIDATE && mode != S_RESOLVE) ||
      (mode == S_CANDIDATE && (!p[2] || (npdim > 0 && !p[1]))) ||
      (mode == S_RESOLVE && !p[37]))
    return (int)cudaErrorInvalidValue;
  ShrinkArgs<T> a{(bool*)p[0],        (const T*)p[1],  (const T*)p[2],
                  (const T*)p[3],     (bool*)p[4],     (bool*)p[5],
                  (const T*)p[6],     (const T*)p[7],  (const T*)p[8],
                  (const T*)p[9],     (T*)p[10],       (T*)p[11],
                  (T*)p[12],          (T*)p[13],       (bool*)p[14],
                  (bool*)p[15],       (bool*)p[16],    (i64*)p[17],
                  (T*)p[18],          (T*)p[19],       (i64*)p[20],
                  (i64*)p[21],        (T*)p[22],       (T*)p[23],
                  (T*)p[24],          (T*)p[25],       (T*)p[26],
                  (T*)p[27],          (T*)p[28],       (bool*)p[29],
                  (bool*)p[30],       (bool*)p[31],    (const T*)p[32],
                  (const T*)p[33],    (const bool*)p[34], (T*)p[35],
                  (bool*)p[36],       (const T*)p[37], q,
                  ndim,               npdim,           mode};
  const int width = lane_width(ndim > npdim ? ndim : npdim);
  const int lanes = BLOCK / width;
  doubling_shrink_kernel<T><<<(q + lanes - 1) / lanes, lanes * width, 0,
                              (cudaStream_t)stream>>>(a, width, lanes);
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
                                               int ndim, int mode,         \
                                               int unused, void* stream) { \
    (void)unused;                                                          \
    return launch_expand<T>(p, q, ndim, mode, stream);                     \
  }                                                                        \
  extern "C" int dynesty_doubling_halve_##TAG(void* const* p, int q,       \
                                              int ndim, int unused1,       \
                                              int unused2, void* stream) { \
    (void)unused1;                                                         \
    (void)unused2;                                                         \
    return launch_halve<T>(p, q, ndim, stream);                            \
  }                                                                        \
  extern "C" int dynesty_doubling_shrink_##TAG(void* const* p, int q,      \
                                               int ndim, int npdim,        \
                                               int mode, void* stream) {   \
    return launch_shrink<T>(p, q, ndim, npdim, mode, stream);              \
  }

DOUBLING_ENTRY(f64, double)
DOUBLING_ENTRY(f32, float)
