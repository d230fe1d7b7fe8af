// One wave of the uniform rejection round, for Hopper (sm_90a).
//
// Replaces the body of the JAX package's jitted lax.while_loop over the
// rejection waves: dynesty_tpu/internal/kernels.py:366 body, :384-399 the
// adaptive width and the lane's checks, :401-429 the compaction into the
// round's slots, loop :433; the membership count of the union of
// ellipsoids, _sample_ellipsoid_union :148 (:165-174); and, after its
// draws, the friends' union of balls or cubes, _sample_friends_union :178
// (the candidate :194, the distances and overlap test :196-203).  XLA
// runs all of it on the device.  The port's wave (dynesty_tpu_torch/internal/kernels.py,
// UnifGraph.wave) draws its candidates with torch (the union's choice, the
// ball and its map, the acceptance uniform) and calls the user's batched
// likelihood between these two kernels; the
// eager wave it replaces took ~30 small launches, the width on the host
// and one device read in its middle.  That code stays as the plain
// version (dynesty_tpu_torch/ops/proposals.py, unif_valid_plain and
// unif_place_plain) that these kernels are held against bit for bit.
//
// Two kernels a wave, on the round's own buffers (ops/proposals.py,
// UnifRound: made once per wave shape, the argument tables filled once):
//   unif_valid, a thread a lane (over a union of m ellipsoids up to 32
//     threads a lane, a slot each): the lane is launched (lane < the
//     wave's width, read from the round's state), its candidate is in the
//     cube (loose where a dimension is not bounded) and, over ellipsoids,
//     accepted by the overlap test: each valid slot's quadratic form
//     (x - c)^T A (x - c) computed here from the round's centres and
//     matrices (once a subtraction and an einsum with (q, m, ncdim)
//     temporaries in torch), nin = the slots whose form is < 1 (or, where
//     none is, <= 1 + 1e-3), nin > 0 and u_accept < 1 / nin.  Over
//     balls and cubes its friends mode (unif_valid_kernel_friends, four
//     warps a lane) forms each lane's candidate from its drawn centre and
//     offset, x = c + offset @ axes, and counts the centres within
//     distance 1 of it, each centre's (c_j - x) @ axes_inv measured by
//     its Euclidean norm (balls) or its largest entry (cubes): nin = that
//     count, at least 1, and u_accept < 1 / nin (once a gather, a cuBLAS
//     product, two (q, N, ncdim) temporaries and ~8 more launches in
//     torch).  It also writes the likelihood's input into the round's
//     buffers: the candidate and the other dimensions' uniforms (once a
//     torch cat) and the same clamped into the cube (once a torch
//     clamp).
//   unif_place, one block: a warp a word of 32 lanes (up to 16 warps,
//     each taking every 16th word past that) and one warp for the state.
//     success = valid & logl > loglstar (logl masked to -inf off the
//     valid lanes).  Each lane's flag, logl and the head of its u and v
//     rows are loaded at once with the state; each warp ballots its words'
//     successes and valid lanes, and the ballots' counts, exchanged once
//     through shared memory (the kernel's one barrier up to 32 words, two
//     past that), give every success's rank (the successes before its
//     word plus __popc of its word's ballot below its lane) and the wave's
//     totals.  Each success's slot is n_filled + rank (or the dump row q
//     past the last free slot), where its rows u, v, logl and its share of
//     the evaluations since the last successful wave (share + (rank <
//     rem)) are written; meanwhile the state warp writes the round's
//     state (filled, waves, evaluations, launched lanes, pending
//     evaluations), the next wave's width and the done flag.
//
// What bounds them on this card: launch latency.  A wave moves a few rows
// of ndim values a lane (~30 kB at q 256, ndim 3 in float64: ~9 ns at
// 3.35 TB/s); an empty launch costs ~0.8 us.  The design answer is to
// take the host out of the wave: the width, the counts and the
// compaction stay on the device, so that where the likelihood runs on
// the card the whole wave -- the draws, these two kernels, the
// likelihood, the blob's indexed copy and the done flag's copy to pinned
// host memory -- is one CUDA graph replay and one flag read
// (internal/kernels.py, UnifGraph).  A launch costs ~0.8 us and each
// chain of dependent trips to memory ~1,000 SM cycles, so unif_valid
// takes in the torch launches on each side of it in the wave (the
// union's membership products before it, the likelihood input's cat and
// clamp after it) and issues its loads in one trip; the union's few
// centres and matrices are read from shared memory, copied there once a
// block, a candidate of 2 or 3 dimensions is held in registers, and a
// lane's forms are spread over up to a warp of threads.  The friends'
// mode has N centres, not a few slots: up to ~16,384 live points in 15
// dimensions (1.97 MB in float64, past a block's shared memory), and
// q N ncdim^2 products a wave, so it is bound by operations at large N
// and ncdim and by the launch below.  Its design, simple first: four
// warps a lane (its 128 threads over the centres j = sub, sub + 128, ...:
// at q 256 only ~8 warps an SM, so each thread's chains are kept short
// and side by side), two lanes a block sharing the centres, which pass
// through shared memory in tiles of ~16 kB (any N), the inverse axes
// staged once a block (held in registers at 2 and 3 dimensions, with the
// candidate; else four entries of a distance summed side by side), the
// counts summed by shuffles and shared memory.  The kernels take only device
// pointers, so a replay reads the round's state, threshold and bound from
// the same buffers as an eager launch.  Inside unif_place the time is
// the launch (~0.8 us) and one chain: a trip to memory, the ballots, the
// barrier, the scan, the stores.  Its first design (two block sums, then
// a chunked rank scan that read the lanes again, at least seven barriers,
// rows copied value by value with each load waited out before the next,
// the state read again and written after the rows by one thread) took
// ~3.2 us at q 256 on this card; this one ~2.2 us.
//
// Rounding: the comparisons are IEEE (NaN false), the counts integers, the
// acceptance's 1 / nin one correctly rounded division (torch's reciprocal),
// the quadratic forms in the fixed order of quad_form and the friends'
// candidate and distances in the fixed order of friends_union_plain
// (ops/proposals.py), with a round-to-nearest intrinsic for every
// difference, product, sum and square root (never contracted into an
// FMA), the cubes' largest entry NaN wherever one is NaN (torch's
// maximum), the clamp torch's (NaN passes), and the width
// the host's numpy float32 formula with a round-to-nearest intrinsic for
// every product, quotient, sum and conversion.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef long long i64;

namespace {

// the round's state vector (ops/proposals.py, U_FILLED ... U_MAX_WAVES)
enum { S_FILLED, S_WAVES, S_NC, S_PROP, S_PENDING, S_WIDTH, S_MAX_WAVES };

template <typename T> struct Op;

template <> struct Op<double> {
  static __device__ __forceinline__ double recip(int n) { return __ddiv_rn(1.0, (double)n); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double sqrt(double a) { return __dsqrt_rn(a); }
  static __device__ __forceinline__ double abs(double a) { return fabs(a); }
};

template <> struct Op<float> {
  static __device__ __forceinline__ float recip(int n) { return __fdiv_rn(1.0f, (float)n); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float sqrt(float a) { return __fsqrt_rn(a); }
  static __device__ __forceinline__ float abs(float a) { return fabsf(a); }
};

// threads a block of unif_valid
const int BLOCK = 128;
// the most threads of unif_place's one block: 16 warps of words and the
// state's
const int PLACE = 17 * 32;

template <typename T>
struct ValidArgs {
  const T* uc;          // (q, ncdim): the candidates
  const T* u_ex;        // (q, ndim - ncdim): the other dimensions, or null
  const T* ua;          // (q,) acceptance uniforms (over ellipsoids)
  const T* ctrs;        // (m, ncdim): the union's centres (with ams)
  const T* ams;         // (m, ncdim, ncdim): its quadratic forms' matrices
  const bool* mask;     // (m,) the valid slots
  const bool* strict;   // (ncdim,) or null: all bounded
  const i64* state;
  bool* valid;
  T* u_prop;            // (q, ndim): the likelihood's input
  T* uclamp;            // (q, ndim): the same, clamped into the cube
  int q, ndim, ncdim, m;
};

// the friends' mode: a union of N identical balls or cubes
template <typename T>
struct FriendsArgs {
  const T* offset;      // (q, ncdim): the draws in the unit ball or cube
  const T* u_ex;        // (q, ndim - ncdim): the other dimensions, or null
  const T* ua;          // (q,) acceptance uniforms
  const i64* idx;       // (q,) each lane's centre
  const T* ctrs;        // (N, ncdim): the centres
  const T* axes;        // (ncdim, ncdim): the unit ball or cube to one
  const T* axes_inv;    // (ncdim, ncdim): and back
  const bool* strict;   // (ncdim,) or null: all bounded
  const i64* state;
  bool* valid;
  T* u_prop;            // (q, ndim): the likelihood's input
  T* uclamp;            // (q, ndim): the same, clamped into the cube
  int q, ndim, ncdim, nctrs;
};

// A candidate's quadratic form in slot j, (x - c)^T A (x - c), in this
// order (ops/proposals.py, ellipsoid_forms_plain, computes the same):
// d_l = x_l - c_l; t_i = A_i0 d_0 + A_i1 d_1 + ... + A_i(n-1) d_(n-1),
// summed left to right; sq = d_0 t_0 + d_1 t_1 + ..., left to right;
// every difference, product and sum rounded once (the intrinsics, never
// an FMA).  NX > 0: n == NX, the candidate's row held in registers;
// NX == 0: any n, each d_l formed again from the row where it is used
// (the same rounding each time).
template <typename T, int NX>
__device__ __forceinline__ T quad_form(const T (&x)[NX > 0 ? NX : 1],
                                       const T* xrow, const T* c,
                                       const T* A, int n) {
  typedef Op<T> O;
  T sq = (T)0.0;
  if (NX > 0) {
    T d[NX > 0 ? NX : 1];
#pragma unroll
    for (int l = 0; l < NX; ++l) d[l] = O::sub(x[l], c[l]);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      T t = O::mul(A[i * NX], d[0]);
#pragma unroll
      for (int l = 1; l < NX; ++l) t = O::add(t, O::mul(A[i * NX + l], d[l]));
      const T p = O::mul(d[i], t);
      sq = i == 0 ? p : O::add(sq, p);
    }
    return sq;
  }
  for (int i = 0; i < n; ++i) {
    T t = O::mul(A[i * n], O::sub(xrow[0], c[0]));
    for (int l = 1; l < n; ++l)
      t = O::add(t, O::mul(A[i * n + l], O::sub(xrow[l], c[l])));
    const T p = O::mul(O::sub(xrow[i], c[i]), t);
    sq = i == 0 ? p : O::add(sq, p);
  }
  return sq;
}

// torch's clamp into the cube: NaN passes, else min(max(x, 0), 1)
template <typename T>
__device__ __forceinline__ T clamp01(T x) {
  return isnan(x) ? x : fmin(fmax(x, (T)0.0), (T)1.0);
}

// A dimension's value into the likelihood's input and its clamp; returns
// its cube check (loose where the dimension is not bounded).
template <typename A, typename T>
__device__ __forceinline__ bool take(const A& a, i64 row, int i, T xi,
                                     bool tight) {
  a.u_prop[row + i] = xi;
  a.uclamp[row + i] = clamp01(xi);
  return tight ? (xi > (T)0.0 && xi < (T)1.0)
               : (xi > (T)-0.5 && xi < (T)1.5);
}

// A lane is a group of W threads (a power of two up to a warp: the union's
// slots, up to 32; one over the cube), BLOCK / W lanes a block.  Every
// load of the lane is issued at once at the top (the wave's width, the
// candidate's row and the cube check's mask, ua) with the block's copy of
// the union's centres, matrices
// and mask into shared memory (`staged`; else they are read where they
// are), before the block's one barrier.  Thread sub computes the forms of
// the slots sub, sub + W, ... (the forms' dependent chains side by side
// on W threads) and writes the dimensions sub, sub + W, ... of the
// likelihood's input; the lane's counts are summed over its threads by
// shuffles, its cube check by a ballot.
template <typename T, int NX>
__global__ void __launch_bounds__(BLOCK) unif_valid_kernel(ValidArgs<T> a,
                                                           int staged,
                                                           int W) {
  extern __shared__ double smem_valid[];
  const unsigned FULL = 0xffffffffu;
  const int t = threadIdx.x, g = t / W, sub = t - g * W;
  const int k = blockIdx.x * (BLOCK / W) + g;
  const bool live = k < a.q;
  const int n = NX > 0 ? NX : a.ncdim, m = a.m;
  const T* xrow = a.uc + (i64)k * n;
  const i64 width = a.state[S_WIDTH];
  T x[NX > 0 ? NX : 1];
  bool tight[NX > 0 ? NX : 1];
  T ua = (T)0.0;
  if (live) {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      x[i] = xrow[i];
      tight[i] = a.strict == nullptr || a.strict[i];
    }
    if (m > 0) ua = a.ua[k];
  }
  const T* ctrs = a.ctrs;
  const T* ams = a.ams;
  const bool* mask = a.mask;
  if (m > 0 && staged) {
    T* sc = (T*)smem_valid;
    T* sa = sc + m * n;
    bool* sm = (bool*)(sa + m * n * n);
    for (int j = t; j < m * n; j += BLOCK) sc[j] = a.ctrs[j];
    for (int j = t; j < m * n * n; j += BLOCK) sa[j] = a.ams[j];
    for (int j = t; j < m; j += BLOCK) sm[j] = a.mask[j];
    __syncthreads();
    ctrs = sc;
    ams = sa;
    mask = sm;
  }

  // the forms of the thread's slots, counted over the lane's threads
  // (torch compares with the Python float 1.0 + 1e-3 cast to T)
  const T loose = (T)(1.0 + 1e-3);
  int nin = 0, nin_loose = 0;
  if (live) {
    for (int j = sub; j < m; j += W) {
      if (!mask[j]) continue;
      const T sq = quad_form<T, NX>(x, xrow, ctrs + j * n, ams + j * n * n,
                                    n);
      nin += sq < (T)1.0;
      nin_loose += sq <= loose;
    }
  }
  for (int o = W >> 1; o > 0; o >>= 1) {
    nin += __shfl_xor_sync(FULL, nin, o);
    nin_loose += __shfl_xor_sync(FULL, nin_loose, o);
  }

  // the cube check, and the candidate and the other dimensions into the
  // likelihood's input: the thread's dimensions
  bool in = true;
  if (live) {
    const i64 row = (i64)k * a.ndim;
    if (NX > 0) {
#pragma unroll
      for (int i = 0; i < NX; ++i)
        if ((i & (W - 1)) == sub)
          in = take(a, row, i, x[i], tight[i]) && in;
    } else {
      for (int i = sub; i < n; i += W)
        in = take(a, row, i, xrow[i],
                  a.strict == nullptr || a.strict[i]) && in;
    }
    const int nex = a.ndim - n;
    for (int i = sub; i < nex; i += W) {
      const T e = a.u_ex[(i64)k * nex + i];
      a.u_prop[row + n + i] = e;
      a.uclamp[row + n + i] = clamp01(e);
    }
  }
  const unsigned vote = __ballot_sync(FULL, in);
  const unsigned group =
      W == 32 ? FULL : ((1u << W) - 1u) << ((t & 31) & ~(W - 1));
  if (!live || sub != 0) return;
  bool ok = (i64)k < width && (vote & group) == group;
  if (m > 0) {
    if (nin == 0) nin = nin_loose;  // the round-off rescue
    ok = ok && nin > 0 && ua < Op<T>::recip(nin);
  }
  a.valid[k] = ok;
}

// NaN wherever either is NaN, else the larger (torch's maximum)
template <typename T>
__device__ __forceinline__ T max_nan(T m, T v) {
  return (v > m || isnan(v)) ? v : m;
}

// A lane's distance to a centre folded in, entry i of t = (c - x) @ B:
// over balls acc + t_i t_i (t_0 t_0 first), over cubes the larger of acc
// and |t_i| (NaN wherever one is NaN).
template <typename T, bool CUBES>
__device__ __forceinline__ T fold(T acc, T t, int i) {
  typedef Op<T> O;
  if (CUBES) return i == 0 ? O::abs(t) : max_nan(acc, O::abs(t));
  const T p = O::mul(t, t);
  return i == 0 ? p : O::add(acc, p);
}

// entries of t summed side by side in the generic loop
const int SIDE = 4;

// Whether the candidate lies within distance 1 of the centre c: t = (c -
// x) @ B (B the inverse axes), t_i = d_0 B_0i + d_1 B_1i + ... left to
// right with d_l = c_l - x_l; over balls sqrt(t_0 t_0 + t_1 t_1 + ...),
// left to right, over cubes the largest |t_i|, at most 1 (NaN: not
// within).  NX > 0: n == NX, the candidate and B in registers; NX == 0:
// any n, read where they lie, SIDE entries of t at a time (their sums'
// chains side by side, each d_l formed once for them: the same rounding
// each time).
template <typename T, int NX, bool CUBES>
__device__ __forceinline__ bool within(const T (&x)[NX > 0 ? NX : 1],
                                       const T (&b)[NX > 0 ? NX * NX : 1],
                                       const T* xs, const T* bs, const T* c,
                                       int n) {
  typedef Op<T> O;
  T acc = (T)0.0;
  if (NX > 0) {
    T d[NX > 0 ? NX : 1];
#pragma unroll
    for (int l = 0; l < NX; ++l) d[l] = O::sub(c[l], x[l]);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      T t = O::mul(d[0], b[i]);
#pragma unroll
      for (int l = 1; l < NX; ++l) t = O::add(t, O::mul(d[l], b[l * NX + i]));
      acc = fold<T, CUBES>(acc, t, i);
    }
  } else {
    for (int i0 = 0; i0 < n; i0 += SIDE) {
      T t[SIDE];
      const T d0 = O::sub(c[0], xs[0]);
#pragma unroll
      for (int r = 0; r < SIDE; ++r)
        t[r] = i0 + r < n ? O::mul(d0, bs[i0 + r]) : (T)0.0;
      for (int l = 1; l < n; ++l) {
        const T d = O::sub(c[l], xs[l]);
#pragma unroll
        for (int r = 0; r < SIDE; ++r)
          if (i0 + r < n) t[r] = O::add(t[r], O::mul(d, bs[l * n + i0 + r]));
      }
#pragma unroll
      for (int r = 0; r < SIDE; ++r)
        if (i0 + r < n) acc = fold<T, CUBES>(acc, t[r], i0 + r);
    }
  }
  if (!CUBES) acc = O::sqrt(acc);
  return acc <= (T)1.0;
}

// The friends' mode's block: lanes of FRIENDS_WARPS warps each (a lane's
// threads over its centres: ~8 warps an SM at q 256), two a block
const int FRIENDS_WARPS = 4;
const int FRIENDS_W = 32 * FRIENDS_WARPS;
const int FRIENDS_BLOCK = 2 * FRIENDS_W;
const int FRIENDS_LANES = FRIENDS_BLOCK / FRIENDS_W;

// The friends' mode: threads g W .. g W + W - 1 of the block (W =
// FRIENDS_W) are lane k.  Thread sub forms the candidate's dimensions
// sub, sub + W, ... (x_i = c_i + (o_0 A_0i + o_1 A_1i + ...), left to
// right), writes them into the likelihood's input and the block's copy
// of the candidate, with the cube check (a ballot a warp); the block
// stages the inverse axes (`staged`) and then, tile by tile of `tile`
// centres, copies the centres into shared memory, where thread sub
// counts the tile's centres sub, sub + W, ... that hold x.  The counts
// and cube checks meet by shuffles and shared memory; thread 0 writes
// the lane's flag.
template <typename T, int NX, bool CUBES>
__global__ void __launch_bounds__(FRIENDS_BLOCK) unif_valid_kernel_friends(
    FriendsArgs<T> a, int tile, int staged) {
  typedef Op<T> O;
  extern __shared__ double smem_friends[];
  __shared__ int scount[FRIENDS_LANES * FRIENDS_WARPS];
  __shared__ int svote[FRIENDS_LANES * FRIENDS_WARPS];
  const unsigned FULL = 0xffffffffu;
  const int t = threadIdx.x, g = t / FRIENDS_W, sub = t - g * FRIENDS_W;
  const int k = blockIdx.x * FRIENDS_LANES + g;
  const bool live = k < a.q;
  const int n = NX > 0 ? NX : a.ncdim;
  T* sb = (T*)smem_friends;                 // n * n where staged
  T* sx = sb + (staged ? n * n : 0);        // FRIENDS_LANES * n
  T* sc = sx + FRIENDS_LANES * n;           // tile * n
  const i64 width = a.state[S_WIDTH];
  i64 c = 0;
  T ua = (T)0.0;
  if (live) {
    c = a.idx[k];
    ua = a.ua[k];
  }
  if (staged)
    for (int j = t; j < n * n; j += FRIENDS_BLOCK) sb[j] = a.axes_inv[j];

  // the candidate and the likelihood's input: the thread's dimensions
  bool in = true;
  if (live) {
    const T* o = a.offset + (i64)k * n;
    const T* cr = a.ctrs + c * n;
    const i64 row = (i64)k * a.ndim;
    for (int i = sub; i < n; i += FRIENDS_W) {
      T s = O::mul(o[0], a.axes[i]);
      for (int l = 1; l < n; ++l) s = O::add(s, O::mul(o[l], a.axes[l * n + i]));
      const T xi = O::add(cr[i], s);
      sx[g * n + i] = xi;
      in = take(a, row, i, xi, a.strict == nullptr || a.strict[i]) && in;
    }
    const int nex = a.ndim - n;
    for (int i = sub; i < nex; i += FRIENDS_W) {
      const T e = a.u_ex[(i64)k * nex + i];
      a.u_prop[row + n + i] = e;
      a.uclamp[row + n + i] = clamp01(e);
    }
  }
  const unsigned vote = __ballot_sync(FULL, in);
  if ((t & 31) == 0) svote[t >> 5] = vote == FULL;
  __syncthreads();
  const T* xs = sx + g * n;
  const T* bs = staged ? sb : a.axes_inv;
  T x[NX > 0 ? NX : 1];
  T b[NX > 0 ? NX * NX : 1];
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = xs[i];
#pragma unroll
  for (int j = 0; j < NX * NX; ++j) b[j] = bs[j];

  // the centres within distance 1, tile by tile
  int nin = 0;
  for (int j0 = 0; j0 < a.nctrs; j0 += tile) {
    const int nt = min(tile, a.nctrs - j0);
    if (j0 > 0) __syncthreads();  // every lane is done with the last tile
    const T* src = a.ctrs + (i64)j0 * n;
    for (int e = t; e < nt * n; e += FRIENDS_BLOCK) sc[e] = src[e];
    __syncthreads();
    if (live)
      for (int j = sub; j < nt; j += FRIENDS_W)
        nin += within<T, NX, CUBES>(x, b, xs, bs, sc + j * n, n);
  }
  for (int o = 16; o > 0; o >>= 1) nin += __shfl_xor_sync(FULL, nin, o);
  if ((t & 31) == 0) scount[t >> 5] = nin;
  __syncthreads();
  if (!live || sub != 0) return;
  int all = 0;
  bool cube = true;
  for (int w = 0; w < FRIENDS_WARPS; ++w) {
    all += scount[g * FRIENDS_WARPS + w];
    cube = cube && svote[g * FRIENDS_WARPS + w];
  }
  // the chosen centre holds x: nin is at least 1
  a.valid[k] = (i64)k < width && cube && ua < O::recip(all > 1 ? all : 1);
}

// n values from src to dst, each chunk's loads issued before its stores
// (a loop of load-store pairs would wait out every load in turn)
template <typename T>
__device__ __forceinline__ void copy_values(T* __restrict__ dst,
                                            const T* __restrict__ src,
                                            int n) {
  for (int i = 0; i < n; i += 8) {
    T x[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (i + j < n) x[j] = src[i + j];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (i + j < n) dst[i + j] = x[j];
  }
}

// The host's numpy float32 width (internal/kernels.py before this kernel;
// the JAX package's :384-393): after a success only ~1.25 need / eff + 4
// lanes of the next wave are launched.
__device__ __forceinline__ i64 next_width(int q, i64 n_filled, i64 n_prop) {
  if (!(n_filled > 0 && n_prop > 0)) return q;
  const float need = __ll2float_rn((i64)q - n_filled);
  const float np = __ll2float_rn(n_prop);
  const float eff = __fdiv_rn(__ll2float_rn(n_filled), 1.0f > np ? 1.0f : np);
  // numpy's float32(1e-6): the double 1e-6 rounded to float
  const float lo = (float)1e-6;
  const float est = __fadd_rn(
      ceilf(__fdiv_rn(__fmul_rn(1.25f, need), lo > eff ? lo : eff)), 4.0f);
  const float qf = __int2float_rn(q);
  return (i64)(qf < est ? qf : est);
}

// values of a lane's u and v rows that unif_place loads with its flags,
// before it knows the lane's slot
const int ROW_REGS = 4;

// avail / div and its remainder (avail >= 0, div >= 1), in 32 bits where
// they fit: the same quotient, without the 64-bit division's subroutine
__device__ __forceinline__ void share_of(i64 avail, i64 div, i64& share,
                                         i64& rem) {
  if (avail <= 0x7fffffff) {
    const unsigned s32 = (unsigned)avail / (unsigned)div;
    share = s32;
    rem = avail - (i64)s32 * div;
  } else {
    share = avail / div;
    rem = avail - share * div;
  }
}

// The warps 0 .. nwarps - 1 take the words of 32 lanes (warp w the words
// w, w + nwarps, ...); the last warp, with no word, writes the round's
// state while they place their successes.
template <typename T>
__global__ void __launch_bounds__(PLACE) unif_place_kernel(
    const bool* __restrict__ valid, const T* __restrict__ u_prop,
    const T* __restrict__ v_prop,
    const T* __restrict__ logl_prop,  // the likelihood's raw values
    const T* __restrict__ loglstar, i64* __restrict__ state,
    bool* __restrict__ done, T* __restrict__ su, T* __restrict__ sv,
    T* __restrict__ sl, i64* __restrict__ snc, i64* __restrict__ dest,
    int q, int ndim, int npdim) {
  // the successes' ballot per word of 32 lanes, each warp's count of
  // valid lanes, and (past 32 words) each word's count of the successes
  // before it and their total
  extern __shared__ unsigned smem[];
  const unsigned FULL = 0xffffffffu;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nwarps = (blockDim.x >> 5) - 1, nw = (q + 31) >> 5;
  const bool state_warp = warp == nwarps;
  unsigned* sbal = smem;
  int* wvalid = (int*)(smem + nw);
  int* before = wvalid + 32;
  const unsigned lt = (1u << lane) - 1u;

  // Every load of the kernel but a long row's tail, issued at once: the
  // threshold, the state (the state warp all of it), and for the lane of
  // the thread's first word its flag, logl and the head of its u and v
  // rows.
  const T lstar = *loglstar;
  const i64 n_filled = state[S_FILLED], pending = state[S_PENDING];
  i64 waves = 0, nc = 0, n_prop = 0, width = 0, max_waves = 0;
  if (state_warp) {
    waves = state[S_WAVES];
    nc = state[S_NC];
    n_prop = state[S_PROP];
    width = state[S_WIDTH];
    max_waves = state[S_MAX_WAVES];
  }
  const int k0 = (warp << 5) + lane;
  const bool in0 = !state_warp && k0 < q;
  const bool ok0 = in0 && valid[k0];
  const T l0 = in0 ? logl_prop[k0] : (T)0;
  T ur[ROW_REGS], vr[ROW_REGS];
#pragma unroll
  for (int i = 0; i < ROW_REGS; ++i) {
    if (in0 && i < ndim) ur[i] = u_prop[(i64)k0 * ndim + i];
    if (in0 && i < npdim) vr[i] = v_prop[(i64)k0 * npdim + i];
  }

  // the wave's successes (a masked lane's -inf never beats the
  // threshold) and evaluations
  if (!state_warp) {
    int n_valid_w = 0;
    for (int j = warp; j < nw; j += nwarps) {
      const int k = (j << 5) + lane;
      const bool first = j == warp;
      const bool ok = first ? ok0 : k < q && valid[k];
      const bool s = ok && (first ? l0 : logl_prop[k]) > lstar;
      const unsigned sb = __ballot_sync(FULL, s);
      n_valid_w += __popc(__ballot_sync(FULL, ok));
      if (lane == 0) sbal[j] = sb;
    }
    if (lane == 0) wvalid[warp] = n_valid_w;
  }
  __syncthreads();

  int x = lane < nwarps ? wvalid[lane] : 0;
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  const i64 n_valid = x;
  // the words' counts scanned: by every warp at once up to 32 words (its
  // lanes hold the exclusive prefixes), else by the state warp into
  // shared memory
  int excl = 0;
  i64 n_succ;
  if (nw <= 32) {
    const int c = lane < nw ? __popc(sbal[lane]) : 0;
    int y = c;
    for (int o = 1; o < 32; o <<= 1) {
      const int z = __shfl_up_sync(FULL, y, o);
      if (lane >= o) y += z;
    }
    excl = y - c;
    n_succ = __shfl_sync(FULL, y, 31);
  } else {
    if (state_warp) {
      int carry = 0;
      for (int j0 = 0; j0 < nw; j0 += 32) {
        const int j = j0 + lane;
        const int c = j < nw ? __popc(sbal[j]) : 0;
        int y = c;
        for (int o = 1; o < 32; o <<= 1) {
          const int z = __shfl_up_sync(FULL, y, o);
          if (lane >= o) y += z;
        }
        if (j < nw) before[j] = carry + y - c;
        carry += __shfl_sync(FULL, y, 31);
      }
      if (lane == 0) before[nw] = carry;
    }
    __syncthreads();
    n_succ = before[nw];
  }
  const i64 free_slots = (i64)q - n_filled;
  const i64 n_new = n_succ < free_slots ? n_succ : free_slots;
  const i64 avail = pending + n_valid;

  if (state_warp) {
    // every thread read the state before the first barrier
    if (lane == 0) {
      const i64 filled = n_filled + n_new;
      const i64 prop = n_prop + width;
      state[S_FILLED] = filled;
      state[S_WAVES] = waves + 1;
      state[S_NC] = nc + n_valid;
      state[S_PROP] = prop;
      state[S_PENDING] = n_new > 0 ? 0 : avail;
      state[S_WIDTH] = next_width(q, filled, prop);
      *done = filled >= q || waves + 1 >= max_waves;
    }
    return;
  }

  // each success's rank, its slot n_filled + rank and the slot's rows
  i64 share, rem;
  share_of(avail, n_new > 1 ? n_new : 1, share, rem);
  for (int j = warp; j < nw; j += nwarps) {
    const int pre = nw <= 32 ? __shfl_sync(FULL, excl, j) : before[j];
    const unsigned sb = sbal[j];
    const int k = (j << 5) + lane;
    if (k >= q) continue;
    const i64 rank = pre + __popc(sb & lt);
    const i64 d = n_filled + rank;
    if ((sb >> lane & 1u) && d < q) {
      const int hu = j == warp ? min(ndim, ROW_REGS) : 0;
      const int hv = j == warp ? min(npdim, ROW_REGS) : 0;
#pragma unroll
      for (int i = 0; i < ROW_REGS; ++i) {
        if (i < hu) su[d * ndim + i] = ur[i];
        if (i < hv) sv[d * npdim + i] = vr[i];
      }
      copy_values(su + d * ndim + hu, u_prop + (i64)k * ndim + hu, ndim - hu);
      copy_values(sv + d * npdim + hv, v_prop + (i64)k * npdim + hv,
                  npdim - hv);
      sl[d] = j == warp ? l0 : logl_prop[k];
      snc[d] = share + (rank < rem);
      dest[k] = d;
    } else {
      dest[k] = q;  // the dump row, as the JAX package's mode="drop"
    }
  }
}

// Whether unif_valid holds a candidate's row in registers at the widths
// the drives run (2 and 3 dimensions: a kernel each, every other width the
// generic loop).  A build with -DUNIF_VALID_ROW_REGISTERS=0 takes the
// generic loop at every width (bench_kernels.py --generic-rows times the
// two against each other).
#ifndef UNIF_VALID_ROW_REGISTERS
#define UNIF_VALID_ROW_REGISTERS 1
#endif

template <typename T, int NX>
void launch_valid_nx(const ValidArgs<T>& a, unsigned grid, size_t smem,
                     int staged, int W, cudaStream_t stream) {
  unif_valid_kernel<T, NX><<<grid, BLOCK, smem, stream>>>(a, staged, W);
}

template <typename T>
int launch_valid(void* const* p, int q, int ndim, int ncdim, int m,
                 void* stream) {
  if (q < 1 || ncdim < 1 || ndim < ncdim || m < 0 || !p[0] || !p[7] ||
      !p[8] || !p[9] || !p[10] || (ndim > ncdim && !p[1]) ||
      (m > 0 && (!p[2] || !p[3] || !p[4] || !p[5])))
    return (int)cudaErrorInvalidValue;
  ValidArgs<T> a{(const T*)p[0],    (const T*)p[1],    (const T*)p[2],
                 (const T*)p[3],    (const T*)p[4],    (const bool*)p[5],
                 (const bool*)p[6], (const i64*)p[7],  (bool*)p[8],
                 (T*)p[9],          (T*)p[10],         q,
                 ndim,              ncdim,             m};
  // the union's arrays staged in shared memory where they fit the
  // default 48 kB
  const size_t bytes =
      m > 0 ? (size_t)m * ncdim * (ncdim + 1) * sizeof(T) + m : 0;
  const int staged = m > 0 && bytes <= 48 * 1024;
  const size_t smem = staged ? bytes : 0;
  // a lane's threads: the largest power of two up to its slots and a warp
  int W = 1;
  while (W * 2 <= m && W * 2 <= 32) W *= 2;
  const unsigned grid = (unsigned)((q + BLOCK / W - 1) / (BLOCK / W));
  cudaStream_t st = (cudaStream_t)stream;
  if (UNIF_VALID_ROW_REGISTERS && ncdim == 2)
    launch_valid_nx<T, 2>(a, grid, smem, staged, W, st);
  else if (UNIF_VALID_ROW_REGISTERS && ncdim == 3)
    launch_valid_nx<T, 3>(a, grid, smem, staged, W, st);
  else
    launch_valid_nx<T, 0>(a, grid, smem, staged, W, st);
  return (int)cudaGetLastError();
}

template <typename T, int NX, bool CUBES>
int launch_friends_nx(const FriendsArgs<T>& a, unsigned grid, size_t smem,
                      int tile, int staged, cudaStream_t stream) {
  if (smem > 47 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        unif_valid_kernel_friends<T, NX, CUBES>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  unif_valid_kernel_friends<T, NX, CUBES>
      <<<grid, FRIENDS_BLOCK, smem, stream>>>(a, tile, staged);
  return (int)cudaGetLastError();
}

template <typename T, bool CUBES>
int launch_friends(void* const* p, int q, int ndim, int ncdim, int nctrs,
                   void* stream) {
  if (q < 1 || ncdim < 1 || ndim < ncdim || nctrs < 1 || !p[0] || !p[2] ||
      !p[3] || !p[4] || !p[5] || !p[6] || !p[8] || !p[9] || !p[10] ||
      !p[11] || (ndim > ncdim && !p[1]))
    return (int)cudaErrorInvalidValue;
  FriendsArgs<T> a{(const T*)p[0],    (const T*)p[1],   (const T*)p[2],
                   (const i64*)p[3],  (const T*)p[4],   (const T*)p[5],
                   (const T*)p[6],    (const bool*)p[7], (const i64*)p[8],
                   (bool*)p[9],       (T*)p[10],        (T*)p[11],
                   q,                 ndim,             ncdim,
                   nctrs};
  // a tile of centres of ~16 kB, a whole number of a lane's threads'
  // worth, no more than N rounded up to that; the lanes' candidates; the
  // inverse axes staged where all three fit the default 48 kB beside the
  // static counts (else read where they lie)
  const size_t sz = sizeof(T);
  int tile = (int)(16384 / ((size_t)ncdim * sz)) / FRIENDS_W * FRIENDS_W;
  tile = tile < FRIENDS_W ? FRIENDS_W : tile > 1024 ? 1024 : tile;
  const int need = (nctrs + FRIENDS_W - 1) / FRIENDS_W * FRIENDS_W;
  tile = tile < need ? tile : need;
  const size_t base = (size_t)(FRIENDS_LANES + tile) * ncdim * sz;
  const size_t inv = (size_t)ncdim * ncdim * sz;
  const int staged = base + inv <= 47 * 1024;
  const size_t smem = base + (staged ? inv : 0);
  const unsigned grid = (unsigned)((q + FRIENDS_LANES - 1) / FRIENDS_LANES);
  cudaStream_t st = (cudaStream_t)stream;
  if (UNIF_VALID_ROW_REGISTERS && ncdim == 2)
    return launch_friends_nx<T, 2, CUBES>(a, grid, smem, tile, staged, st);
  if (UNIF_VALID_ROW_REGISTERS && ncdim == 3)
    return launch_friends_nx<T, 3, CUBES>(a, grid, smem, tile, staged, st);
  return launch_friends_nx<T, 0, CUBES>(a, grid, smem, tile, staged, st);
}

template <typename T>
int launch_place(void* const* p, int q, int ndim, int npdim, void* stream) {
  if (q < 1 || ndim < 1 || npdim < 0 || !p[1] || !p[3] ||
      (npdim > 0 && !p[2]))
    return (int)cudaErrorInvalidValue;
  // a warp a word of 32 lanes, up to the block's most, and the state's
  const int nw = (q + 31) / 32;
  const int threads = 32 * ((nw < PLACE / 32 - 1 ? nw : PLACE / 32 - 1) + 1);
  const size_t smem = (size_t)nw * 8 + 33 * 4;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        unif_place_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  unif_place_kernel<T><<<1, threads, smem, (cudaStream_t)stream>>>(
      (const bool*)p[0], (const T*)p[1], (const T*)p[2], (const T*)p[3],
      (const T*)p[4], (i64*)p[5], (bool*)p[6], (T*)p[7], (T*)p[8],
      (T*)p[9], (i64*)p[10], (i64*)p[11], q, ndim, npdim);
  return (int)cudaGetLastError();
}

}  // namespace

// p: the tensors' pointers in the order of each kernel's parameters
#define UNIF_ENTRY(TAG, T)                                                 \
  extern "C" int dynesty_unif_valid_##TAG(void* const* p, int q,           \
                                          int ndim, int ncdim, int m,      \
                                          void* stream) {                  \
    return launch_valid<T>(p, q, ndim, ncdim, m, stream);                  \
  }                                                                        \
  extern "C" int dynesty_unif_balls_##TAG(void* const* p, int q,           \
                                          int ndim, int ncdim, int nctrs,  \
                                          void* stream) {                  \
    return launch_friends<T, false>(p, q, ndim, ncdim, nctrs, stream);     \
  }                                                                        \
  extern "C" int dynesty_unif_cubes_##TAG(void* const* p, int q,           \
                                          int ndim, int ncdim, int nctrs,  \
                                          void* stream) {                  \
    return launch_friends<T, true>(p, q, ndim, ncdim, nctrs, stream);      \
  }                                                                        \
  extern "C" int dynesty_unif_place_##TAG(void* const* p, int q, int ndim, \
                                          int npdim, int unused,           \
                                          void* stream) {                  \
    (void)unused;                                                          \
    return launch_place<T>(p, q, ndim, npdim, stream);                     \
  }

UNIF_ENTRY(f64, double)
UNIF_ENTRY(f32, float)
