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
// the card the whole wave -- the draws, the union's products, these two
// kernels, the likelihood, the blob's indexed copy and the done flag's
// copy to pinned host memory -- is one CUDA graph replay and one flag read
// (internal/kernels.py, UnifGraph).  The kernels take only device
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
// the most threads of unif_place's one block: 16 warps of words and the
// state's
const int PLACE = 17 * 32;

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
