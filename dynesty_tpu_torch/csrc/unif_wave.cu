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
//     balls and cubes its friends mode (unif_valid_kernel_friends, a
//     thread a lane, the centres split over the grid) forms each lane's
//     candidate from its drawn centre and
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
// q N (2 ncdim^2 + 2 ncdim) adds and multiplies a wave, each its own
// instruction (the fixed orders forbid an FMA), so it is bound by the
// fp64 issue rate at large N and ncdim and by the launch below.  Its
// design: a thread a lane and the centres split over the grid
// (ops/proposals.py, friends_geometry, picks it): a block is eight warps
// over the same 32 lanes, and the grid ceil(q / 32) lane groups times C
// chunks of ~N / C centres, C chosen for ~two blocks an SM, so that each
// centre is read from L2 once a lane group. A block's chunk (and the
// inverse axes) goes into shared memory by cp.async issued first, while
// warp 0 forms its lanes' candidates; one wait and one barrier, then each
// warp counts its eighth of the chunk, all 32 threads reading one centre
// at a time (a broadcast). Up to 16 dimensions the candidate is in
// registers, up to 4 the inverse axes too, and two to four centres' sums
// run side by side sharing each 16-byte read of four columns of the
// inverse axes (asm loads, which the compiler cannot hoist out of the
// centres' loop into n^2 registers); above, the generic loop. A lane's
// count is summed over the block's warps in shared memory and added, with
// one for the block, to the lane's 64-bit word in one atomic (integer
// sums: the same bits in any order); the lane's last block, which sees the
// grid's count, writes its flag and zeroes the word. (A 32-bit count with
// a ticket a lane group and a __threadfence took two more dependent trips:
// 5.26 against 4.42 us at q 256, 2048 centres in 3-D, float64, on an
// H100.) Lanes past the wave's width or outside the cube count nothing.
// The square root is not taken: see Dist.  The kernels take only device
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
// difference, product and sum (never contracted into an FMA), the balls'
// rounded square root compared with 1 by its exact threshold on the
// square and the cubes' largest entry (NaN wherever one is NaN, torch's
// maximum) by every entry's test (Dist), the clamp torch's (NaN passes),
// and the width
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
  static __device__ __forceinline__ double abs(double a) { return fabs(a); }
  // the float after 1: 1 + 2^-52
  static __device__ __forceinline__ double one_up() {
    return 0x1.0000000000001p0;
  }
};

template <> struct Op<float> {
  static __device__ __forceinline__ float recip(int n) { return __fdiv_rn(1.0f, (float)n); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float abs(float a) { return fabsf(a); }
  // the float after 1: 1 + 2^-23
  static __device__ __forceinline__ float one_up() { return 0x1.000002p0f; }
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
  // (32 groups,): each lane's count (high 32 bits) and its blocks done
  // (low 32), zero between launches
  unsigned long long* counts;
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

// A lane's distance to a centre, folded entry by entry of t = (c - x) @ B
// (first, then add), and whether it is at most 1 (within): the root's
// threshold on the square over balls, every entry's test over cubes.
template <typename T, bool CUBES> struct Dist;

// Over balls the sum t_0 t_0 + t_1 t_1 + ..., left to right, which the
// plain version compares, through its correctly rounded square root, with
// 1: that holds exactly where the sum is <= 1 + u, u the spacing of the
// floats above 1 (2^-52 in float64, 2^-23 in float32; Op::one_up).  The
// root is monotone; sqrt(1 + u) < 1 + u / 2 (its square is 1 + u + u^2 /
// 4), the midpoint of 1 and 1 + u, so it rounds to 1; sqrt(1 + 2u) > 1 +
// u / 2, so it rounds to 1 + u or above; no float lies between 1 + u and
// 1 + 2u.  NaN and inf fail both tests, 0 passes both, and a sum of
// rounded squares is never below -0.  tests/test_torch_friends_union.py
// checks the equivalence with torch over every float within 2,000 ulps
// of 1.
template <typename T> struct Dist<T, false> {
  T s;
  __device__ __forceinline__ void first(T t) { s = Op<T>::mul(t, t); }
  __device__ __forceinline__ void add(T t) {
    s = Op<T>::add(s, Op<T>::mul(t, t));
  }
  __device__ __forceinline__ bool within() const {
    return s <= Op<T>::one_up();
  }
};

// Over cubes the plain version's largest |t_i|, NaN wherever one is
// (torch's maximum), is <= 1 exactly where every |t_i| <= 1 (a NaN one
// fails): that is kept instead of the largest.
template <typename T> struct Dist<T, true> {
  bool in;
  __device__ __forceinline__ void first(T t) {
    in = Op<T>::abs(t) <= (T)1.0;
  }
  __device__ __forceinline__ void add(T t) {
    in = in & (Op<T>::abs(t) <= (T)1.0);
  }
  __device__ __forceinline__ bool within() const { return in; }
};

// the friends' block: FRIENDS_WARPS warps over the same 32 lanes
const int FRIENDS_WARPS = 8;
const int FRIENDS_BLOCK = 32 * FRIENDS_WARPS;
// the dynamic shared memory a block takes without asking and at most (the
// 48 kB default and the 227 kB ceiling less the kernel's static counts;
// ops/proposals.py, friends_geometry, holds a chunk to them)
const size_t FRIENDS_SMEM_DEFAULT = 46 * 1024;
const size_t FRIENDS_SMEM_MAX = 225 * 1024;
static_assert(FRIENDS_SMEM_DEFAULT + (FRIENDS_WARPS + 1) * 32 * 4 <=
                      48 * 1024 &&
                  FRIENDS_SMEM_MAX + (FRIENDS_WARPS + 1) * 32 * 4 <= 232448,
              "the friends kernel's static counts leave its budgets");
// the widest candidate held in registers (a kernel each width up to it),
// and the widest whose inverse axes are held there whole
const int FRIENDS_NX = 16;
const int FRIENDS_BREG = 4;
// centres whose sums run side by side (sharing each read of the inverse
// axes) at a candidate width: four up to FRIENDS_BREG, two up to 8, one
// above; columns of the inverse axes read at once (t's entries side by
// side)
__host__ __device__ constexpr int friends_p(int nx) {
  return nx <= FRIENDS_BREG ? 4 : nx <= 8 ? 2 : 1;
}
const int FRIENDS_CB = 4;
// entries of t summed side by side in the generic loop
const int SIDE = 4;

// The shared memory's row strides: the inverse axes' rows padded to a
// whole number of FRIENDS_CB values, the centres' to 16 bytes
// (ops/proposals.py, friends_layout, computes the same).
__host__ __device__ constexpr int pad_b(int n) {
  return (n + FRIENDS_CB - 1) / FRIENDS_CB * FRIENDS_CB;
}
template <typename T>
__host__ __device__ constexpr int pad_c(int n) {
  return (n + 16 / (int)sizeof(T) - 1) / (16 / (int)sizeof(T)) *
         (16 / (int)sizeof(T));
}

// A block's shared memory: the inverse axes (n rows of pad_b, where
// staged), the chunk's centres (per rows of pad_c), the lanes' candidates
// (32 rows of n).
template <typename T>
size_t friends_smem(int n, int per, int staged) {
  return ((staged ? (size_t)n * pad_b(n) : 0) + (size_t)per * pad_c<T>(n) +
          (size_t)32 * n) *
         sizeof(T);
}

// a 16-byte load's values
template <typename T> struct Vec16;
template <> struct Vec16<double> {
  typedef double2 V;
  static __device__ __forceinline__ double at(const V& v, int u) {
    return u == 0 ? v.x : v.y;
  }
};
template <> struct Vec16<float> {
  typedef float4 V;
  static __device__ __forceinline__ float at(const V& v, int u) {
    return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
  }
};

// N values of shared memory from src (16-byte aligned) by 16-byte loads
template <typename T, int N>
__device__ __forceinline__ void load16(T (&dst)[N], const T* src) {
  typedef Vec16<T> W;
  const int V = 16 / sizeof(T);
#pragma unroll
  for (int v = 0; v < (N + V - 1) / V; ++v) {
    const typename W::V w = reinterpret_cast<const typename W::V*>(src)[v];
#pragma unroll
    for (int u = 0; u < V; ++u)
      if (v * V + u < N) dst[v * V + u] = W::at(w, u);
  }
}

// The same as an asm load the compiler keeps where it stands: a plain
// load of the inverse axes, the same at every centre, is hoisted out of
// the centres' loop, all n^2 values held in registers (spilled past ~9
// dimensions in float64).  Read after the barrier that shows the copy.
__device__ __forceinline__ void lds16(double (&dst)[FRIENDS_CB],
                                      const double* src) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(src);
  asm volatile("ld.shared.v2.f64 {%0, %1}, [%4];\n"
               "ld.shared.v2.f64 {%2, %3}, [%4+16];\n"
               : "=d"(dst[0]), "=d"(dst[1]), "=d"(dst[2]), "=d"(dst[3])
               : "r"(a));
}
__device__ __forceinline__ void lds16(float (&dst)[FRIENDS_CB],
                                      const float* src) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(src);
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(dst[0]), "=f"(dst[1]), "=f"(dst[2]), "=f"(dst[3])
               : "r"(a));
}

// One value copied from device to shared memory without a register
// (cp.async): a thread's copies are all in flight at once.  copies_done()
// waits for the thread's own; a barrier after it shows them to the block.
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

// The centres lo .. hi - 1 of the block's copy `sc` within distance 1 of
// the candidate x (n == NX <= FRIENDS_NX, in registers): for each, d_l =
// c_l - x_l and t_i = d_0 B_0i + d_1 B_1i + ... left to right (B the
// inverse axes, `sb`), folded t_0, t_1, ... in order.  friends_p(NX)
// centres at a time, their sums side by side; B's columns FRIENDS_CB at a
// time, each row's read once for them (B whole in registers up to
// FRIENDS_BREG dimensions).  The same operations in the same order as the
// plain version's: every sum's bits are its.
template <typename T, int NX, bool CUBES>
__device__ __forceinline__ int count_nx(const T (&x)[NX], const T* sb,
                                        const T* sc, int lo, int hi) {
  typedef Op<T> O;
  constexpr int PB = pad_b(NX), PC = pad_c<T>(NX), P = friends_p(NX);
  constexpr bool BREG = NX <= FRIENDS_BREG;
  T breg[BREG ? NX * NX : 1];
  if (BREG) {
#pragma unroll
    for (int l = 0; l < NX; ++l)
#pragma unroll
      for (int i = 0; i < NX; ++i) breg[l * NX + i] = sb[l * PB + i];
  }
  int nin = 0;
  for (int j = lo; j < hi; j += P) {
    // the last group past hi repeats centre j, counted once
    T d[P][NX];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      T c[NX];
      load16(c, sc + (j + p < hi ? j + p : j) * PC);
#pragma unroll
      for (int l = 0; l < NX; ++l) d[p][l] = O::sub(c[l], x[l]);
    }
    Dist<T, CUBES> dist[P];
#pragma unroll
    for (int i0 = 0; i0 < NX; i0 += FRIENDS_CB) {
      T tt[P][FRIENDS_CB];
#pragma unroll
      for (int l = 0; l < NX; ++l) {
        T b[FRIENDS_CB];
        if (BREG) {
#pragma unroll
          for (int r = 0; r < FRIENDS_CB; ++r)
            b[r] = i0 + r < NX ? breg[l * NX + i0 + r] : (T)0.0;
        } else {
          lds16(b, sb + l * PB + i0);
        }
#pragma unroll
        for (int p = 0; p < P; ++p)
#pragma unroll
          for (int r = 0; r < FRIENDS_CB; ++r)
            if (i0 + r < NX)
              tt[p][r] = l == 0 ? O::mul(d[p][0], b[r])
                                : O::add(tt[p][r], O::mul(d[p][l], b[r]));
      }
#pragma unroll
      for (int r = 0; r < FRIENDS_CB; ++r)
#pragma unroll
        for (int p = 0; p < P; ++p) {
          if (i0 + r == 0)
            dist[p].first(tt[p][r]);
          else if (i0 + r < NX)
            dist[p].add(tt[p][r]);
        }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) nin += (j + p < hi) && dist[p].within();
  }
  return nin;
}

// The same at any n: the candidate's row `xs` and B (`bs`, rows of
// `bstride`) read where they lie, SIDE entries of t at a time (their
// sums' chains side by side, each d_l formed again for them: the same
// rounding each time).
template <typename T, bool CUBES>
__device__ int count_any(const T* xs, const T* bs, int bstride, const T* sc,
                         int pc, int n, int lo, int hi) {
  typedef Op<T> O;
  int nin = 0;
  for (int j = lo; j < hi; ++j) {
    const T* c = sc + j * pc;
    Dist<T, CUBES> dist;
    for (int i0 = 0; i0 < n; i0 += SIDE) {
      T tt[SIDE];
      const T d0 = O::sub(c[0], xs[0]);
#pragma unroll
      for (int r = 0; r < SIDE; ++r)
        tt[r] = i0 + r < n ? O::mul(d0, bs[i0 + r]) : (T)0.0;
      for (int l = 1; l < n; ++l) {
        const T d = O::sub(c[l], xs[l]);
#pragma unroll
        for (int r = 0; r < SIDE; ++r)
          if (i0 + r < n)
            tt[r] = O::add(tt[r], O::mul(d, bs[l * bstride + i0 + r]));
      }
#pragma unroll
      for (int r = 0; r < SIDE; ++r) {
        if (i0 + r == 0)
          dist.first(tt[r]);
        else if (i0 + r < n)
          dist.add(tt[r]);
      }
    }
    nin += dist.within();
  }
  return nin;
}

// The friends' mode: block b is lane group b / chunks (lanes 32 g .. 32 g
// + 31, thread `lane` of every warp) and chunk b % chunks of the centres
// (per centres from chunk * per, fewer in the last).  Its copies of the
// chunk and (`staged`) the inverse axes are issued first; meanwhile warp
// 0 forms each lane's candidate x_i = c_i + (o_0 A_0i + o_1 A_1i + ...),
// left to right, into shared memory, its cube check and whether it counts
// (launched and in the cube), and the chunk-0 block writes the
// likelihood's input.  After one wait and one barrier each warp counts its
// share of the chunk for every lane that counts; warp 0 sums a lane's
// counts over the warps and adds them to the lane's word with the
// block's arrival, and the lane's last block writes its flag from the
// total (the chosen centre holds x: nin is at least 1) and zeroes the
// word.
template <typename T, int NX, bool CUBES>
__global__ void __launch_bounds__(FRIENDS_BLOCK, 2) unif_valid_kernel_friends(
    FriendsArgs<T> a, int chunks, int per, int staged) {
  typedef Op<T> O;
  extern __shared__ __align__(16) double smem_friends[];
  __shared__ int scount[FRIENDS_WARPS][32];
  __shared__ int sact[32];
  const unsigned FULL = 0xffffffffu;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int group = blockIdx.x / chunks, chunk = blockIdx.x - group * chunks;
  const int k = group * 32 + lane;
  const bool live = k < a.q;
  const int n = NX > 0 ? NX : a.ncdim;
  const int pb = pad_b(n), pc = pad_c<T>(n);
  const int j0 = chunk * per, nc = min(per, a.nctrs - j0);
  T* sb = (T*)smem_friends;
  T* sc = sb + (staged ? n * pb : 0);
  T* sx = sc + per * pc;

  const T* src = a.ctrs + (i64)j0 * n;
  for (int e = t; e < nc * n; e += FRIENDS_BLOCK) {
    const int j = e / n;
    copy_async(sc + j * pc + (e - j * n), src + e);
  }
  if (staged)
    for (int e = t; e < n * n; e += FRIENDS_BLOCK) {
      const int l = e / n;
      copy_async(sb + l * pb + (e - l * n), a.axes_inv + e);
    }

  // warp 0: the lanes' candidates, cube checks, acceptance uniforms and
  // widths (kept for the flags), and in chunk 0 the likelihood's input
  bool in = live, launched = false;
  T ua = (T)0.0;
  if (warp == 0) {
    launched = live && (i64)k < a.state[S_WIDTH];
    if (live) {
      ua = a.ua[k];
      const T* o = a.offset + (i64)k * n;
      const T* cr = a.ctrs + a.idx[k] * n;
      const i64 row = (i64)k * a.ndim;
      T* xs = sx + lane * n;
      auto put = [&](int i, T xi) {
        xs[i] = xi;
        const bool tight = a.strict == nullptr || a.strict[i];
        in = in && (tight ? (xi > (T)0.0 && xi < (T)1.0)
                          : (xi > (T)-0.5 && xi < (T)1.5));
        if (chunk == 0) {
          a.u_prop[row + i] = xi;
          a.uclamp[row + i] = clamp01(xi);
        }
      };
      if constexpr (NX > 0) {
#pragma unroll
        for (int i = 0; i < NX; ++i) {
          T s = O::mul(o[0], a.axes[i]);
#pragma unroll
          for (int l = 1; l < NX; ++l)
            s = O::add(s, O::mul(o[l], a.axes[l * NX + i]));
          put(i, O::add(cr[i], s));
        }
      } else {
        for (int i = 0; i < n; ++i) {
          T s = O::mul(o[0], a.axes[i]);
          for (int l = 1; l < n; ++l)
            s = O::add(s, O::mul(o[l], a.axes[l * n + i]));
          put(i, O::add(cr[i], s));
        }
      }
      if (chunk == 0) {
        const int nex = a.ndim - n;
        for (int i = 0; i < nex; ++i) {
          const T e = a.u_ex[(i64)k * nex + i];
          a.u_prop[row + n + i] = e;
          a.uclamp[row + n + i] = clamp01(e);
        }
      }
    }
    sact[lane] = launched && in;
  }
  copies_done();
  __syncthreads();

  // the warp's share of the chunk
  const int share = (nc + FRIENDS_WARPS - 1) / FRIENDS_WARPS;
  const int lo = warp * share, hi = min(nc, lo + share);
  int cnt = 0;
  if (sact[lane] && lo < hi) {
    if constexpr (NX > 0) {
      T x[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) x[i] = sx[lane * NX + i];
      cnt = count_nx<T, NX, CUBES>(x, sb, sc, lo, hi);
    } else {
      cnt = count_any<T, CUBES>(sx + lane * n, staged ? sb : a.axes_inv,
                                staged ? pb : n, sc, pc, n, lo, hi);
    }
  }
  scount[warp][lane] = cnt;
  __syncthreads();
  if (warp != 0) return;

  // the lane's count and its block done over the grid in one atomic: the
  // lane's last block writes its flag and zeroes the word
  if (!live) return;
  int add = 0;
#pragma unroll
  for (int w = 0; w < FRIENDS_WARPS; ++w) add += scount[w][lane];
  const unsigned long long inc = (unsigned long long)add << 32 | 1ull;
  const unsigned long long old = atomicAdd(a.counts + k, inc);
  if ((unsigned)old != (unsigned)(chunks - 1)) return;
  a.counts[k] = 0ull;
  const int all = (int)((old + inc) >> 32);
  a.valid[k] = launched && in && ua < O::recip(all > 1 ? all : 1);
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
// the drives run (over ellipsoids 2 and 3 dimensions, the friends' mode
// every width up to FRIENDS_NX: a kernel each, every other width the
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
int launch_friends_kernel(const FriendsArgs<T>& a, unsigned grid, int chunks,
                          int per, int staged, size_t smem,
                          cudaStream_t stream) {
  if (smem > FRIENDS_SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (smem > FRIENDS_SMEM_DEFAULT) {
    cudaError_t err = cudaFuncSetAttribute(
        unif_valid_kernel_friends<T, NX, CUBES>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  unif_valid_kernel_friends<T, NX, CUBES>
      <<<grid, FRIENDS_BLOCK, smem, stream>>>(a, chunks, per, staged);
  return (int)cudaGetLastError();
}

// the kernel of the candidate's width: NX = ncdim up to FRIENDS_NX, else
// the generic loop (every width in a -DUNIF_VALID_ROW_REGISTERS=0 build)
template <typename T, bool CUBES, int NX = FRIENDS_NX>
int launch_friends_nx(const FriendsArgs<T>& a, unsigned grid, int chunks,
                      int per, int staged, size_t smem, cudaStream_t stream) {
  if constexpr (NX == 0) {
    return launch_friends_kernel<T, 0, CUBES>(a, grid, chunks, per, staged,
                                              smem, stream);
  } else {
    if (UNIF_VALID_ROW_REGISTERS && a.ncdim == NX)
      return launch_friends_kernel<T, NX, CUBES>(a, grid, chunks, per,
                                                 staged, smem, stream);
    return launch_friends_nx<T, CUBES, NX - 1>(a, grid, chunks, per, staged,
                                               smem, stream);
  }
}

// chunks, per and staged: ops/proposals.py, friends_geometry
template <typename T, bool CUBES>
int launch_friends(void* const* p, int q, int ndim, int ncdim, int nctrs,
                   int chunks, int per, int staged, void* stream) {
  if (q < 1 || ncdim < 1 || ndim < ncdim || nctrs < 1 || chunks < 1 ||
      per < 1 || (i64)(chunks - 1) * per >= nctrs ||
      (i64)chunks * per < nctrs || !p[0] || !p[2] || !p[3] || !p[4] ||
      !p[5] || !p[6] || !p[8] || !p[9] || !p[10] || !p[11] || !p[12] ||
      (ndim > ncdim && !p[1]) ||
      (!staged && UNIF_VALID_ROW_REGISTERS && ncdim <= FRIENDS_NX))
    return (int)cudaErrorInvalidValue;
  const i64 blocks = (i64)((q + 31) / 32) * chunks;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  FriendsArgs<T> a{(const T*)p[0],    (const T*)p[1],   (const T*)p[2],
                   (const i64*)p[3],  (const T*)p[4],   (const T*)p[5],
                   (const T*)p[6],    (const bool*)p[7], (const i64*)p[8],
                   (bool*)p[9],       (T*)p[10],        (T*)p[11],
                   (unsigned long long*)p[12],          q,
                   ndim,              ncdim,            nctrs};
  return launch_friends_nx<T, CUBES>(a, (unsigned)blocks, chunks, per,
                                     staged,
                                     friends_smem<T>(ncdim, per, staged),
                                     (cudaStream_t)stream);
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
  extern "C" int dynesty_unif_balls_##TAG(                                \
      void* const* p, int q, int ndim, int ncdim, int nctrs, int chunks,   \
      int per, int staged, void* stream) {                                 \
    return launch_friends<T, false>(p, q, ndim, ncdim, nctrs, chunks, per, \
                                    staged, stream);                       \
  }                                                                        \
  extern "C" int dynesty_unif_cubes_##TAG(                                \
      void* const* p, int q, int ndim, int ncdim, int nctrs, int chunks,   \
      int per, int staged, void* stream) {                                 \
    return launch_friends<T, true>(p, q, ndim, ncdim, nctrs, chunks, per,  \
                                   staged, stream);                        \
  }                                                                        \
  extern "C" int dynesty_unif_place_##TAG(void* const* p, int q, int ndim, \
                                          int npdim, int unused,           \
                                          void* stream) {                  \
    (void)unused;                                                          \
    return launch_place<T>(p, q, ndim, npdim, stream);                     \
  }

UNIF_ENTRY(f64, double)
UNIF_ENTRY(f32, float)
