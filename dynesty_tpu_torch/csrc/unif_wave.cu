// One wave of the uniform rejection round, for Hopper (sm_90a).
//
// Replaces the body of the JAX package's jitted lax.while_loop over the
// rejection waves: dynesty_tpu/internal/kernels.py:366 body, :384-399 the
// adaptive width and the lane's checks, :401-429 the compaction into the
// round's slots, loop :433; and the membership count of the union of
// ellipsoids, _sample_ellipsoid_union :148 (:165-174).  XLA runs all of it
// on the device.  The port's wave (dynesty_tpu_torch/internal/kernels.py,
// UnifGraph.wave) draws its candidates with torch (the union's choice, the
// ball, the products of the membership test, the acceptance uniform) and
// calls the user's batched likelihood between these two kernels; the
// eager wave it replaces took ~30 small launches, the width on the host
// and one device read in its middle.  That code stays as the plain
// version (dynesty_tpu_torch/ops/proposals.py, unif_valid_plain and
// unif_place_plain) that these kernels are held against bit for bit.
//
// Two kernels a wave, on the round's own buffers (ops/proposals.py,
// UnifRound: made once per wave shape, the argument tables filled once):
//   unif_valid, one thread a lane: the lane is launched (lane < the
//     wave's width, read from the round's state), its candidate is in the
//     cube (loose where a dimension is not bounded) and, over ellipsoids,
//     accepted by the overlap test: nin = the valid slots whose quadratic
//     form is < 1 (or, where none is, <= 1 + 1e-3), nin > 0 and
//     u_accept < 1 / nin; over balls and cubes the eager acceptance flag.
//   unif_place, one block: success = valid & logl > loglstar (logl masked
//     to -inf off the valid lanes), each success's rank by a block scan
//     in chunks of the block, its slot n_filled + rank (or the dump row q
//     past the last free slot), the rows u, v, logl written there and the
//     slot's share of the evaluations since the last successful wave
//     (share + (rank < rem)); then the round's state (filled, waves,
//     evaluations, launched lanes, pending evaluations), the next wave's
//     width and the done flag.
//
// What bounds it on this card: nothing the card measures.  A wave moves a
// few rows of ndim values a lane (~30 kB at q 256, ndim 3 in float64: ~9
// ns at 3.35 TB/s); a launch costs about a microsecond.  The design
// answer is to take the host out of the wave: the width, the counts and
// the compaction stay on the device, so that where the likelihood runs on
// the card the whole wave -- the draws, the union's products, these two
// kernels, the likelihood, the blob's indexed copy and the done flag's
// copy to pinned host memory -- is one CUDA graph replay and one flag read
// (internal/kernels.py, UnifGraph).  The kernels take only device
// pointers, so a replay reads the round's state, threshold and bound from
// the same buffers as an eager launch.
//
// Rounding: the comparisons are IEEE (NaN false), the counts integers, the
// acceptance's 1 / nin one correctly rounded division (torch's reciprocal),
// and the width the host's numpy float32 formula with a round-to-nearest
// intrinsic for every product, quotient, sum and conversion.

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
};

template <> struct Op<float> {
  static __device__ __forceinline__ float recip(int n) { return __fdiv_rn(1.0f, (float)n); }
};

// threads a block of unif_valid
const int BLOCK = 128;
// threads of unif_place's one block
const int PLACE = 256;

template <typename T>
__global__ void __launch_bounds__(BLOCK) unif_valid_kernel(
    const T* __restrict__ uc,          // (q, ncdim): the candidates
    const T* __restrict__ sq,          // (q, m) quadratic forms, or null
    const T* __restrict__ ua,          // (q,) acceptance uniforms (with sq)
    const bool* __restrict__ accept,   // (q,) friends' acceptance, or null
    const bool* __restrict__ mask,     // (m,) the valid slots (with sq)
    const bool* __restrict__ strict,   // (ncdim,) or null: all bounded
    const i64* __restrict__ state, bool* __restrict__ valid, int q,
    int ncdim, int m) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= q) return;
  bool ok = (i64)k < state[S_WIDTH];
  for (int d = 0; d < ncdim; ++d) {
    const T x = uc[(i64)k * ncdim + d];
    ok = ok && ((strict == nullptr || strict[d])
                    ? (x > (T)0.0 && x < (T)1.0)
                    : (x > (T)-0.5 && x < (T)1.5));
  }
  if (sq != nullptr) {
    // torch compares with the Python float 1.0 + 1e-3 cast to T
    const T loose = (T)(1.0 + 1e-3);
    int nin = 0, nin_loose = 0;
    for (int j = 0; j < m; ++j) {
      const T s = sq[(i64)k * m + j];
      if (mask[j]) {
        nin += s < (T)1.0;
        nin_loose += s <= loose;
      }
    }
    if (nin == 0) nin = nin_loose;  // the round-off rescue
    ok = ok && nin > 0 && ua[k] < Op<T>::recip(nin);
  }
  if (accept != nullptr) ok = ok && accept[k];
  valid[k] = ok;
}

// the sum over the block (every thread gets it); `buf` holds a value a
// warp
__device__ __forceinline__ i64 block_sum(i64 x, i64* buf) {
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  __syncthreads();
  if (lane == 0) buf[w] = x;
  __syncthreads();
  i64 s = 0;
  for (int i = 0; i < PLACE / 32; ++i) s += buf[i];
  return s;
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

template <typename T>
__global__ void __launch_bounds__(PLACE) unif_place_kernel(
    const bool* __restrict__ valid, const T* __restrict__ u_prop,
    const T* __restrict__ v_prop,
    const T* __restrict__ logl_prop,  // the likelihood's raw values
    const T* __restrict__ loglstar, i64* __restrict__ state,
    bool* __restrict__ done, T* __restrict__ su, T* __restrict__ sv,
    T* __restrict__ sl, i64* __restrict__ snc, i64* __restrict__ dest,
    int q, int ndim, int npdim) {
  __shared__ i64 buf[PLACE / 32];
  __shared__ int warp_incl[PLACE / 32];
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const T lstar = *loglstar;
  const i64 n_filled = state[S_FILLED], pending = state[S_PENDING];

  // the wave's successes and evaluations (a masked lane's -inf never
  // beats the threshold)
  i64 n_succ = 0, n_valid = 0;
  for (int k = t; k < q; k += PLACE) {
    const bool ok = valid[k];
    n_valid += ok;
    n_succ += ok && logl_prop[k] > lstar;
  }
  n_succ = block_sum(n_succ, buf);
  n_valid = block_sum(n_valid, buf);
  const i64 free_slots = (i64)q - n_filled;
  const i64 n_new = n_succ < free_slots ? n_succ : free_slots;
  const i64 avail = pending + n_valid;
  const i64 div = n_new > 1 ? n_new : 1;
  const i64 share = avail / div, rem = avail - share * div;

  // each success's rank: an inclusive scan over the lanes, a chunk of
  // the block at a time, the chunks' totals carried
  i64 carry = 0;
  for (int base = 0; base < q; base += PLACE) {
    const int k = base + t;
    const bool in = k < q && valid[k];
    const bool succ = in && logl_prop[k] > lstar;
    int x = succ;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    __syncthreads();
    if (lane == 31) warp_incl[w] = x;
    __syncthreads();
    int before = 0, total = 0;
    for (int i = 0; i < PLACE / 32; ++i) {
      before += i < w ? warp_incl[i] : 0;
      total += warp_incl[i];
    }
    if (k < q) {
      const i64 rank = carry + before + x - 1;
      const i64 d = n_filled + rank;
      if (succ && d < q) {
        for (int j = 0; j < ndim; ++j)
          su[d * ndim + j] = u_prop[(i64)k * ndim + j];
        for (int j = 0; j < npdim; ++j)
          sv[d * npdim + j] = v_prop[(i64)k * npdim + j];
        sl[d] = logl_prop[k];
        snc[d] = share + (rank < rem);
        dest[k] = d;
      } else {
        dest[k] = q;  // the dump row, as the JAX package's mode="drop"
      }
    }
    carry += total;
  }

  __syncthreads();
  if (t == 0) {
    const i64 filled = n_filled + n_new;
    const i64 waves = state[S_WAVES] + 1;
    const i64 n_prop = state[S_PROP] + state[S_WIDTH];
    state[S_FILLED] = filled;
    state[S_WAVES] = waves;
    state[S_NC] += n_valid;
    state[S_PROP] = n_prop;
    state[S_PENDING] = n_new > 0 ? 0 : avail;
    state[S_WIDTH] = next_width(q, filled, n_prop);
    *done = filled >= q || waves >= state[S_MAX_WAVES];
  }
}

template <typename T>
int launch_valid(void* const* p, int q, int ncdim, int m, void* stream) {
  if (q < 1 || ncdim < 1 || !p[0] || !p[6] || !p[7] ||
      (p[1] && (m < 1 || !p[2] || !p[4])))
    return (int)cudaErrorInvalidValue;
  unif_valid_kernel<T><<<(q + BLOCK - 1) / BLOCK, BLOCK, 0,
                         (cudaStream_t)stream>>>(
      (const T*)p[0], (const T*)p[1], (const T*)p[2], (const bool*)p[3],
      (const bool*)p[4], (const bool*)p[5], (const i64*)p[6], (bool*)p[7],
      q, ncdim, m);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_place(void* const* p, int q, int ndim, int npdim, void* stream) {
  if (q < 1 || ndim < 1 || npdim < 0 || !p[1] || !p[3] ||
      (npdim > 0 && !p[2]))
    return (int)cudaErrorInvalidValue;
  unif_place_kernel<T><<<1, PLACE, 0, (cudaStream_t)stream>>>(
      (const bool*)p[0], (const T*)p[1], (const T*)p[2], (const T*)p[3],
      (const T*)p[4], (i64*)p[5], (bool*)p[6], (T*)p[7], (T*)p[8],
      (T*)p[9], (i64*)p[10], (i64*)p[11], q, ndim, npdim);
  return (int)cudaGetLastError();
}

}  // namespace

// p: the tensors' pointers in the order of each kernel's parameters
#define UNIF_ENTRY(TAG, T)                                                 \
  extern "C" int dynesty_unif_valid_##TAG(void* const* p, int q,           \
                                          int ncdim, int m, int unused,    \
                                          void* stream) {                  \
    (void)unused;                                                          \
    return launch_valid<T>(p, q, ncdim, m, stream);                        \
  }                                                                        \
  extern "C" int dynesty_unif_place_##TAG(void* const* p, int q, int ndim, \
                                          int npdim, int unused,           \
                                          void* stream) {                  \
    (void)unused;                                                          \
    return launch_place<T>(p, q, ndim, npdim, stream);                     \
  }

UNIF_ENTRY(f64, double)
UNIF_ENTRY(f32, float)
