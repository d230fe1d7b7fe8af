// The per-step updates of the random-walk proposal round, for Hopper
// (sm_90a).
//
// Replaces the body of the JAX package's jitted lax.scan over the walk
// steps: dynesty_tpu/internal/kernels.py:486-510 step, scan :512, which XLA
// runs on the device.  The port's host loop (dynesty_tpu_torch/internal/
// kernels.py, rwalk_walk) draws each step's unit-ball offsets and extra
// dimensions with torch, multiplies them by the lanes' axes with
// torch.einsum, and calls the user's batched likelihood; around those calls
// the eager code took ~18 small launches a step.  It stays as the plain
// version (dynesty_tpu_torch/ops/proposals.py, rwalk_propose_plain and
// rwalk_accept_plain) that these kernels are held against bit for bit.
//
// Two kernels a step, one thread a lane:
//   rwalk_propose: u_prop = u[:, :ncdim] + du * scale, the extra
//     dimensions' draws appended, periodic dimensions wrapped and
//     reflective ones reflected, and the cube check (loose where a
//     dimension is not bounded).
//   rwalk_accept: accept = ok & (logl_prop > loglstar), the lane's point,
//     v and logl moved where it accepts, the accept/reject tallies; the
//     walk's state lives in the round's own buffers, updated in place.
//
// What bounds it on this card: nothing the card measures.  A step moves a
// few rows of ndim values a lane (~80 kB at q 256, ndim 15: ~0.02 us at
// 3.35 TB/s); a launch costs microseconds of latency.  The design answer is
// the count of launches: two in place of ~18.
//
// Rounding: each eager op rounds once, so the product and the sum are
// explicit round-to-nearest intrinsics, which nvcc never contracts into an
// FMA.  The wrapping copies torch's CUDA remainder: fmod (exact), then b
// added where the remainder's sign differs from b's; the reflection is
// torch's where(m < 1, m, 2 - m) on the remainder by 2.

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

const int BLOCK = 128;

// torch.remainder's CUDA kernel for floating types
template <typename T>
__device__ __forceinline__ T torch_remainder(T a, T b) {
  T mod = Op<T>::fmod_(a, b);
  if ((mod != (T)0.0) && ((b < (T)0.0) != (mod < (T)0.0)))
    mod = Op<T>::add(mod, b);
  return mod;
}

template <typename T>
struct ProposeArgs {
  const T* u;            // (q, ndim)
  const T* du;           // (q, ncdim): axes @ unit-ball draw
  const T* scale;        // 0-d
  const T* u_ex;         // (q, ndim - ncdim) or null
  const bool* periodic;  // (ndim,) or null
  const bool* reflective;
  const bool* nonbounded;  // (ndim,) or null: all bounded
  T* u_prop;
  bool* ok;
  int q, ndim, ncdim;
};

template <typename T>
__global__ void rwalk_propose_kernel(ProposeArgs<T> a) {
  typedef Op<T> O;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= a.q) return;
  const T sc = *a.scale;
  const int n_extra = a.ndim - a.ncdim;
  bool in = true;
  for (int d = 0; d < a.ndim; ++d) {
    T p = d < a.ncdim
              ? O::add(a.u[(i64)k * a.ndim + d],
                       O::mul(a.du[(i64)k * a.ncdim + d], sc))
              : a.u_ex[(i64)k * n_extra + d - a.ncdim];
    if (a.periodic != nullptr && a.periodic[d])
      p = torch_remainder(p, (T)1.0);
    if (a.reflective != nullptr && a.reflective[d]) {
      const T m2 = torch_remainder(p, (T)2.0);
      p = m2 < (T)1.0 ? m2 : O::sub((T)2.0, m2);
    }
    a.u_prop[(i64)k * a.ndim + d] = p;
    const bool strict = a.nonbounded == nullptr || a.nonbounded[d];
    in = in && (strict ? (p > (T)0.0 && p < (T)1.0)
                       : (p > (T)-0.5 && p < (T)1.5));
  }
  a.ok[k] = in;
}

template <typename T>
struct AcceptArgs {
  T* u;
  T* v;
  T* logl;
  i64* n_acc;
  i64* n_rej;
  bool* accept;
  const T* u_prop;
  const bool* ok;
  const T* v_prop;
  const T* logl_prop;
  const T* loglstar;
  int q, ndim, npdim;
};

template <typename T>
__global__ void rwalk_accept_kernel(AcceptArgs<T> a) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= a.q) return;
  const T lp = a.logl_prop[k];
  const bool acc = a.ok[k] && lp > *a.loglstar;
  if (acc) {
    for (int d = 0; d < a.ndim; ++d)
      a.u[(i64)k * a.ndim + d] = a.u_prop[(i64)k * a.ndim + d];
    for (int d = 0; d < a.npdim; ++d)
      a.v[(i64)k * a.npdim + d] = a.v_prop[(i64)k * a.npdim + d];
    a.logl[k] = lp;
  }
  a.n_acc[k] += acc;
  a.n_rej[k] += !acc;
  a.accept[k] = acc;
}

template <typename T>
int launch_propose(void* const* p, int q, int ndim, int ncdim,
                   void* stream) {
  if (q < 1 || ncdim < 1 || ncdim > ndim || (ncdim < ndim && !p[3]))
    return (int)cudaErrorInvalidValue;
  ProposeArgs<T> a{(const T*)p[0],    (const T*)p[1],    (const T*)p[2],
                   (const T*)p[3],    (const bool*)p[4], (const bool*)p[5],
                   (const bool*)p[6], (T*)p[7],          (bool*)p[8],
                   q,                 ndim,              ncdim};
  rwalk_propose_kernel<T><<<(q + BLOCK - 1) / BLOCK, BLOCK, 0,
                            (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_accept(void* const* p, int q, int ndim, int npdim, void* stream) {
  if (q < 1 || ndim < 1 || npdim < 0) return (int)cudaErrorInvalidValue;
  AcceptArgs<T> a{(T*)p[0],       (T*)p[1],          (T*)p[2],
                  (i64*)p[3],     (i64*)p[4],        (bool*)p[5],
                  (const T*)p[6], (const bool*)p[7], (const T*)p[8],
                  (const T*)p[9], (const T*)p[10],   q,
                  ndim,           npdim};
  rwalk_accept_kernel<T><<<(q + BLOCK - 1) / BLOCK, BLOCK, 0,
                           (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// p: the tensors' pointers in the order of ProposeArgs / AcceptArgs
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
