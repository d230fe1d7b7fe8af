// The per-step updates of the random-walk proposal round, for Hopper
// (sm_90a).
//
// Replaces the body of the JAX package's jitted lax.scan over the walk
// steps: dynesty_tpu/internal/kernels.py:486-510 step, scan :512, which XLA
// runs on the device.  The port's walk (dynesty_tpu_torch/internal/
// kernels.py, rwalk_walk and RWalkGraph) draws each step's unit-ball
// offsets and extra dimensions with torch, multiplies them by the lanes'
// axes with torch.einsum, and calls the user's batched likelihood between
// these two kernels.  It stays as the plain version (dynesty_tpu_torch/ops/
// proposals.py, rwalk_propose_plain and rwalk_accept_plain) that these
// kernels are held against bit for bit.
//
// Two kernels a step, on the round's own buffers (ops/proposals.py,
// RWalkRound: made once per round shape, the argument tables filled once):
//   rwalk_propose: u_prop = u[:, :ncdim] + du * scale, the extra
//     dimensions' draws appended, periodic dimensions wrapped and
//     reflective ones reflected, the point clamped into the cube (where the
//     likelihood is evaluated) and the cube check (loose where a dimension
//     is not bounded).
//   rwalk_accept: the likelihood's -inf mask outside the cube, accept =
//     ok & (logl_prop > loglstar), the lane's point, v and logl moved where
//     it accepts, the accept/reject tallies, all in place.
//
// What bounds it on this card: nothing the card measures.  A step moves a
// few rows of ndim values a lane (~100 kB at q 256, ndim 15: ~0.03 us at
// 3.35 TB/s); a launch costs microseconds.  The design answers are two.
// First, one thread per (lane, dimension) element, so that a warp's loads
// and stores are neighbouring addresses and no thread walks a row: the
// first design ran one thread a lane over its ndim dimensions, 2 blocks at
// q 256, each dimension a serial round trip to memory (its pointers could
// alias, so no load was hoisted).  Every pointer here is __restrict__, and
// the three (ndim,) masks are read once per block into shared memory as
// one byte of flags a dimension.  The cube check is an AND over a lane's
// threads: one ballot of the warp where ndim <= 32 (a lane's threads are a
// power-of-two group inside one warp), else one vote per warp and a flag
// in shared memory.  Second, the host leaves the step: with a likelihood
// on the card a whole walk of `walks` steps -- the draws, the einsum, these
// two kernels, the likelihood and the blob select -- is one CUDA graph
// replay (internal/kernels.py, RWalkGraph).  The kernels take only device
// pointers, so a replay reads the round's scale, loglstar and state from
// the same buffers as an eager launch.
//
// Rounding: each eager op rounds once, so the product and the sum are
// explicit round-to-nearest intrinsics, which nvcc never contracts into an
// FMA.  The wrapping copies torch's CUDA remainder: fmod (exact), then b
// added where the remainder's sign differs from b's; the reflection is
// torch's where(m < 1, m, 2 - m) on the remainder by 2; the clamp torch's
// (NaN passes).  Comparisons are IEEE, NaN false, as torch's.

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
  static __device__ __forceinline__ double fmod_(double a, double b) { return fmod(a, b); }
};

template <> struct Op<float> {
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float fmod_(float a, float b) { return fmodf(a, b); }
};

// threads a block: rwalk_propose's lane groups fill it, rwalk_accept's
// elements run over it
const int BLOCK = 128;
// dimensions whose flags a block keeps in shared memory; past it a thread
// reads its dimension's masks itself
const int MASK_SMEM = 2048;
enum { F_PERIODIC = 1, F_REFLECTIVE = 2, F_STRICT = 4 };

// torch.remainder's CUDA kernel for floating types
template <typename T>
__device__ __forceinline__ T torch_remainder(T a, T b) {
  T mod = Op<T>::fmod_(a, b);
  if ((mod != (T)0.0) && ((b < (T)0.0) != (mod < (T)0.0)))
    mod = Op<T>::add(mod, b);
  return mod;
}

__device__ __forceinline__ unsigned char dim_flags(
    const bool* __restrict__ periodic, const bool* __restrict__ reflective,
    const bool* __restrict__ nonbounded, int d) {
  return (periodic != nullptr && periodic[d] ? F_PERIODIC : 0) |
         (reflective != nullptr && reflective[d] ? F_REFLECTIVE : 0) |
         (nonbounded == nullptr || nonbounded[d] ? F_STRICT : 0);
}

// One thread per (lane, dimension): a lane is a group of `width` threads
// (a power of two <= 32, or a multiple of 32 that loops over the
// dimensions past it), `lanes` groups a block.
template <typename T>
__global__ void __launch_bounds__(BLOCK) rwalk_propose_kernel(
    const T* __restrict__ u,            // (q, ndim)
    const T* __restrict__ du,           // (q, ncdim): axes @ unit-ball draw
    const T* __restrict__ scale,        // 0-d
    const T* __restrict__ u_ex,         // (q, ndim - ncdim) or null
    const bool* __restrict__ periodic,  // (ndim,) or null
    const bool* __restrict__ reflective,
    const bool* __restrict__ nonbounded,  // (ndim,) or null: all bounded
    T* __restrict__ u_prop, T* __restrict__ uclamp, bool* __restrict__ ok,
    int q, int ndim, int ncdim, int width, int lanes) {
  typedef Op<T> O;
  __shared__ unsigned char flags[MASK_SMEM];
  __shared__ int lane_in[BLOCK / 32];
  const int t = threadIdx.x;
  const int g = t / width, sub = t - g * width;
  const int k = blockIdx.x * lanes + g;
  const int n_smem = ndim < MASK_SMEM ? ndim : MASK_SMEM;
  for (int d = t; d < n_smem; d += blockDim.x)
    flags[d] = dim_flags(periodic, reflective, nonbounded, d);
  if (width > 32 && sub == 0) lane_in[g] = 1;
  __syncthreads();

  bool in = true;
  if (k < q) {
    const T sc = *scale;
    const int n_extra = ndim - ncdim;
    for (int d = sub; d < ndim; d += width) {
      const i64 e = (i64)k * ndim + d;
      T p = d < ncdim ? O::add(u[e], O::mul(du[(i64)k * ncdim + d], sc))
                      : u_ex[(i64)k * n_extra + d - ncdim];
      const unsigned char f =
          d < MASK_SMEM ? flags[d]
                        : dim_flags(periodic, reflective, nonbounded, d);
      if (f & F_PERIODIC) p = torch_remainder(p, (T)1.0);
      if (f & F_REFLECTIVE) {
        const T m2 = torch_remainder(p, (T)2.0);
        p = m2 < (T)1.0 ? m2 : O::sub((T)2.0, m2);
      }
      u_prop[e] = p;
      // torch's CUDA clamp: NaN passes, else min(max(p, 0), 1)
      uclamp[e] = isnan(p) ? p : fmin(fmax(p, (T)0.0), (T)1.0);
      in = in && ((f & F_STRICT) ? (p > (T)0.0 && p < (T)1.0)
                                 : (p > (T)-0.5 && p < (T)1.5));
    }
  }
  // the cube check: AND over the lane's threads (threads past q vote true)
  if (width <= 32) {
    const unsigned vote = __ballot_sync(0xffffffffu, in);
    const unsigned group =
        width == 32 ? 0xffffffffu
                    : ((1u << width) - 1u) << ((t & 31) & ~(width - 1));
    if (sub == 0 && k < q) ok[k] = (vote & group) == group;
  } else {
    if (!__all_sync(0xffffffffu, in) && (t & 31) == 0) lane_in[g] = 0;
    __syncthreads();
    if (sub == 0 && k < q) ok[k] = lane_in[g] != 0;
  }
}

// One thread per element of a lane's u (ndim) and v (npdim) moves; each
// decides for its own lane, and the lane's first thread writes its logl,
// tallies and accept flag.
template <typename T>
__global__ void __launch_bounds__(BLOCK) rwalk_accept_kernel(
    T* __restrict__ u, T* __restrict__ v, T* __restrict__ logl,
    i64* __restrict__ n_acc, i64* __restrict__ n_rej,
    bool* __restrict__ accept, const T* __restrict__ u_prop,
    const bool* __restrict__ ok, const T* __restrict__ v_prop,
    const T* __restrict__ logl_prop,  // the likelihood's raw values
    const T* __restrict__ loglstar, int q, int ndim, int npdim) {
  const int row = ndim + npdim;
  const i64 e = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (i64)q * row) return;
  const int k = (int)(e / row), j = (int)(e - (i64)k * row);
  const bool in = ok[k];
  // the mask the eager loop applied after the likelihood call (`in`
  // gates the move as well, so no output depends on it)
  const T lp = in ? logl_prop[k] : (T)-INFINITY;
  const bool acc = in && lp > *loglstar;
  if (acc) {
    if (j < ndim)
      u[(i64)k * ndim + j] = u_prop[(i64)k * ndim + j];
    else
      v[(i64)k * npdim + j - ndim] = v_prop[(i64)k * npdim + j - ndim];
  }
  if (j == 0) {
    if (acc) logl[k] = lp;
    n_acc[k] += acc;
    n_rej[k] += !acc;
    accept[k] = acc;
  }
}

// threads a lane for rwalk_propose
int lane_width(int ndim) {
  if (ndim > 32) return ndim >= BLOCK ? BLOCK : (ndim + 31) / 32 * 32;
  int w = 1;
  while (w < ndim) w *= 2;
  return w;
}

template <typename T>
int launch_propose(void* const* p, int q, int ndim, int ncdim,
                   void* stream) {
  if (q < 1 || ncdim < 1 || ncdim > ndim || (ncdim < ndim && !p[3]) ||
      !p[1])
    return (int)cudaErrorInvalidValue;
  const int width = lane_width(ndim), lanes = BLOCK / width;
  rwalk_propose_kernel<T><<<(q + lanes - 1) / lanes, lanes * width, 0,
                            (cudaStream_t)stream>>>(
      (const T*)p[0], (const T*)p[1], (const T*)p[2], (const T*)p[3],
      (const bool*)p[4], (const bool*)p[5], (const bool*)p[6], (T*)p[7],
      (T*)p[8], (bool*)p[9], q, ndim, ncdim, width, lanes);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_accept(void* const* p, int q, int ndim, int npdim, void* stream) {
  if (q < 1 || ndim < 1 || npdim < 0 || !p[8] || !p[9])
    return (int)cudaErrorInvalidValue;
  const i64 n = (i64)q * (ndim + npdim);
  rwalk_accept_kernel<T><<<(unsigned)((n + BLOCK - 1) / BLOCK), BLOCK, 0,
                           (cudaStream_t)stream>>>(
      (T*)p[0], (T*)p[1], (T*)p[2], (i64*)p[3], (i64*)p[4], (bool*)p[5],
      (const T*)p[6], (const bool*)p[7], (const T*)p[8], (const T*)p[9],
      (const T*)p[10], q, ndim, npdim);
  return (int)cudaGetLastError();
}

__global__ void empty_kernel() {}

}  // namespace

// p: the tensors' pointers in the order of each kernel's parameters
#define RWALK_ENTRY(TAG, T)                                                \
  extern "C" int dynesty_rwalk_propose_##TAG(void* const* p, int q,        \
                                             int ndim, int ncdim,          \
                                             int unused, void* stream) {   \
    (void)unused;                                                          \
    return launch_propose<T>(p, q, ndim, ncdim, stream);                   \
  }                                                                        \
  extern "C" int dynesty_rwalk_accept_##TAG(void* const* p, int q,         \
                                            int ndim, int npdim,           \
                                            int unused, void* stream) {    \
    (void)unused;                                                          \
    return launch_accept<T>(p, q, ndim, npdim, stream);                    \
  }

RWALK_ENTRY(f64, double)
RWALK_ENTRY(f32, float)

// An empty kernel launched the same way (`blocks` blocks of BLOCK threads
// through the same entry signature): the floor a launch of these kernels
// costs on the card, which chip_smoke.py times beside them.
extern "C" int dynesty_rwalk_empty_f64(void* const* p, int blocks, int b,
                                       int c, int d, void* stream) {
  (void)p; (void)b; (void)c; (void)d;
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  empty_kernel<<<blocks, BLOCK, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
