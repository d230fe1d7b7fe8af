// The record and live assembly of one fused round, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: it is the part of the JAX package's jitted
// round that follows the consume scan, dynesty_tpu/internal/fused.py:146
// one_round (after the lax.cond of :423): the round's record rows (each
// dead point from the live set or from the proposal that refilled its
// slot), the proposals block and the live matrix refilled with the last
// proposal accepted into each slot.  XLA fuses it into the round's
// program.  The port ran it as ~40 small torch launches a round
// (dynesty_tpu_torch/ops/consume.py, round_assemble_plain, which these
// kernels are held against bit for bit).
//
// Two kernels, launched back to back on the caller's stream:
//   assemble_records, a thread an element of the round's output tiles:
//     the (q, 1 + il + 11) records, the (q, il + 4) proposals block, then
//     the accepts (0 or 1 in the float type), delta_logz and the (q, 2)
//     lane stats, written at the round's offset (ridx * q rows, ridx read
//     from the device), so that a warp's stores are neighbouring
//     addresses.  A thread's loads are issued before any wait: the
//     round's scalars, its element's entry indices and the accepts of the
//     first words; then the element's gather (a dead original's live row
//     or a proposal's row).  The accepts' prefix comes from warp ballots
//     (the q accepts are q bytes, so every warp redoes it: up to 32 words
//     each lane of a warp keeps one word's ballot and the accepts before
//     it, with no barrier; past 32 words the block exchanges them through
//     shared memory): entry_it = it0 + the accepts before the entry.  The
//     thread of an entry's first record column also writes entry_it (a
//     scratch vector the refill reads) and, where the entry is accepted,
//     marks its slot: atomicMax(mark[slot], entry + 1).  The record reads
//     the live row of a dead original, so the live matrix must not change
//     before this kernel ends.
//   assemble_refill, a thread a live slot: its mark is one more than the
//     last entry accepted into the slot (0: none; the maximum does not
//     depend on the atomics' order), written to `last` (-1: kept); a
//     marked slot's row is refilled from that proposal (u, v, logl,
//     entry_it, bound -1, birth) and its mark put back to 0.
//
// The mark (an int32 a slot, made zeroed by assemble_buffers) is 0
// between calls: every records launch is followed by its refill in the
// same entry, and the refill clears what the records launch marked, on a
// gated round and in a captured replay alike.
//
// What bounds it on this card: latency, not bytes.  At (2048, 256) and
// 3 dimensions a round moves ~144 kB (~43 ns at 3.35 TB/s); each kernel is
// a launch (~0.8 us) and a chain of dependent trips to memory: records,
// the entry indices then the gathered rows (~3.1 us); refill, the mark
// then the refilled row (~1.6 us).  The first design (one block for the
// records, a prefix sum with two barriers a step, rows written a thread
// a row, and a refill thread scanning all q entries for its slot:
// O(nlive * q) work) took 26 us.  This one does O(q + nlive) work over
// the whole grid, issues every load that needs no other load at once,
// and copies rows a chunk of loads before its stores.  Every operand is a
// device pointer (the round's index too), so that the whole round's
// epilogue stays one CUDA graph replay (internal/fused.py).
//
// Rounding: only copies, integer sums and exact conversions (an int64 to
// the float type, as torch's .to()).

#include <cuda_runtime.h>
#include <stdint.h>

typedef long long i64;

namespace {

const int BLOCK = 256;
// the pointer table's length, and the one entry that may be null
const int N_PTR = 29, P_RIDX = 19;
// words of 32 accepts whose loads a thread issues at once
const int CHUNK = 8;

// the operands, in the order of ops/consume.py's pointer table
struct Args {
  const i64 *worsts, *srcs;
  const bool* accepts;
  // the consume scan's columns: logl, logvol, logwt, logz, logzvar, h,
  // nc (int64), delta_logz, n
  const void *r_logl, *r_logvol, *r_logwt, *r_logz, *r_logzvar, *r_h;
  const i64* r_nc;
  const void *r_dlogz, *r_n;
  void* live;             // (nlive, ndim + npdim + 4), refilled in place
  const void* qrows;      // (q, >= ndim + npdim + 1): u | v | logl
  const i64* qnc;         // (q,)
  const void* lane;       // (q, >= 2) lane stats
  const i64* it0;         // 0-d
  const void *birth, *threshold;  // 0-d
  const i64* ridx;        // 0-d, or null (round 0)
  void *recs, *props, *acc, *dlogz, *lane_out, *thr;
  i64 *entry_it, *last;   // (q,) scratch, (nlive,)
  int* mark;              // (nlive,) scratch, 0 between calls
  int q, nlive, ndim, npdim, rs, ls;
};

// one of the consume scan's six float columns, by a register select (an
// indexed array of the pointers would live in local memory)
template <typename T>
__device__ __forceinline__ const T* scan_col(const Args& a, int k) {
  const void* p = k == 0 ? a.r_logl : k == 1 ? a.r_logvol
                : k == 2 ? a.r_logwt : k == 3 ? a.r_logz
                : k == 4 ? a.r_logzvar : a.r_h;
  return (const T*)p;
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

// the accepts before entry i, from the words' ballots and prefixes
__device__ __forceinline__ i64 acc_before(const unsigned* bal,
                                          const int* before, i64 i) {
  const int j = (int)(i >> 5);
  return before[j] + __popc(bal[j] & ((1u << (i & 31)) - 1u));
}

template <typename T>
__global__ void __launch_bounds__(BLOCK) assemble_records(Args a) {
  // the accepts' ballot per word of 32 entries, then each word's count of
  // the accepts before it
  extern __shared__ unsigned smem[];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int q = a.q, il = a.ndim + a.npdim;
  const int w = il + 12, pw = il + 4, lw = il + 4;
  const int nw = (q + 31) >> 5;
  unsigned* bal = smem;
  int* before = (int*)(smem + nw);
  const i64 n_rec = (i64)q * w, n_prop = (i64)q * pw;
  const i64 e = (i64)blockIdx.x * BLOCK + t;
  // the accepts of the first CHUNK words, loaded with the scalars and the
  // element's indices, ahead of the element's gather
  bool acc_first[CHUNK];
#pragma unroll
  for (int c = 0; c < CHUNK; ++c) {
    const int i = (c << 5) + lane;
    acc_first[c] = c < nw && i < q && a.accepts[i];
  }
  const i64 it0 = *a.it0;
  const i64 r = a.ridx ? *a.ridx : 0;

  // The element's value, where it needs no prefix, loaded before the
  // scan so that its gather is in flight across the barriers.  The tiles:
  // (q, il + 12) records, (q, il + 4) proposals, then q accepts, q
  // delta_logz and the (q, 2) lane stats.  `ent` is the entry whose
  // accepts-before the thread still needs: its own entry_it (a record's
  // first column) or the `it` of a record taken from proposal `src`.
  T v = 0;
  T* dst = nullptr;
  i64 ent = -1;
  bool own_it = false;
  const T* live = (const T*)a.live;
  const T* qrows = (const T*)a.qrows;
  if (e < n_rec) {
    // 32-bit division (the launch keeps the tiles below 2^31 elements):
    // the loads wait on it
    const int i = (int)((unsigned)e / (unsigned)w), k = (int)e - i * w;
    const i64 wst = a.worsts[i], src = a.srcs[i];
    const bool orig = src < 0;
    const T* lrow = live + wst * lw;
    dst = (T*)a.recs + r * n_rec + e;
    if (k == 0) {
      v = (T)wst;
      ent = i;
      own_it = true;
      if (a.accepts[i] && wst >= 0 && wst < a.nlive)
        atomicMax(a.mark + wst, i + 1);
      if (i == 0) ((T*)a.thr)[r] = *(const T*)a.threshold;
    } else if (k <= il) {
      v = orig ? lrow[k - 1] : qrows[src * a.rs + (k - 1)];
    } else {
      const int c = k - 1 - il;
      if (c < 6) v = scan_col<T>(a, c)[i];
      else if (c == 6) v = (T)a.r_nc[i];
      else if (c == 7) {
        if (orig) v = lrow[il + 1];
        else ent = src;
      } else if (c == 8) v = orig ? lrow[il + 2] : (T)-1;
      else if (c == 9) v = ((const T*)a.r_n)[i];
      else v = orig ? lrow[il + 3] : *(const T*)a.birth;
    }
  } else if (e < n_rec + n_prop) {
    const int f = (int)(e - n_rec);
    const int i = (int)((unsigned)f / (unsigned)pw), k = f - i * pw;
    dst = (T*)a.props + r * n_prop + f;
    if (k <= il) v = qrows[(i64)i * a.rs + k];
    else if (k == il + 1) v = (T)a.qnc[i];
    else v = ((const T*)a.lane)[(i64)i * a.ls + (k - il - 2)];
  } else if (e < n_rec + n_prop + 4 * (i64)q) {
    i64 f = e - n_rec - n_prop;
    const i64 row0 = r * q;
    if (f < q) {
      dst = (T*)a.acc + row0 + f;
      v = a.accepts[f] ? (T)1 : (T)0;
    } else if (f < 2 * (i64)q) {
      f -= q;
      dst = (T*)a.dlogz + row0 + f;
      v = ((const T*)a.r_dlogz)[f];
    } else {
      f -= 2 * (i64)q;  // the lane stats, row by row
      dst = (T*)a.lane_out + 2 * row0 + f;
      v = ((const T*)a.lane)[(f >> 1) * a.ls + (f & 1)];
    }
  }

  // the accepts before `ent`
  i64 before_ent = 0;
  if (nw <= 32) {
    // every warp ballots the accepts itself, no warp waiting on another:
    // lane j keeps word j's ballot and the accepts before that word
    unsigned own_b = 0;
    int own_pre = 0, run = 0;
    for (int j0 = 0; j0 < nw; j0 += CHUNK) {
      bool p[CHUNK];
#pragma unroll
      for (int c = 0; c < CHUNK; ++c) {
        const int i = ((j0 + c) << 5) + lane;
        p[c] = j0 == 0 ? acc_first[c] : j0 + c < nw && i < q && a.accepts[i];
      }
#pragma unroll
      for (int c = 0; c < CHUNK; ++c) {
        if (j0 + c >= nw) break;
        const unsigned b = __ballot_sync(0xffffffffu, p[c]);
        if (lane == j0 + c) {
          own_b = b;
          own_pre = run;
        }
        run += __popc(b);
      }
    }
    const int src_lane = ent >= 0 ? (int)(ent >> 5) : 0;
    const unsigned b = __shfl_sync(0xffffffffu, own_b, src_lane);
    const int pre = __shfl_sync(0xffffffffu, own_pre, src_lane);
    before_ent = pre + __popc(b & ((1u << (ent & 31)) - 1u));
  } else {
    // past 32 words: the ballots through shared memory, warp 0's scan
    for (int j = warp; j < nw; j += BLOCK / 32) {
      const int i = (j << 5) + lane;
      const unsigned b = __ballot_sync(0xffffffffu, i < q && a.accepts[i]);
      if (lane == 0) bal[j] = b;
    }
    __syncthreads();
    if (warp == 0) {
      // the exclusive prefix of the words' counts, 32 words a step
      int carry = 0;
      for (int j0 = 0; j0 < nw; j0 += 32) {
        const int j = j0 + lane;
        const int c = j < nw ? __popc(bal[j]) : 0;
        int x = c;
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, x, o);
          if (lane >= o) x += y;
        }
        if (j < nw) before[j] = carry + x - c;
        carry += __shfl_sync(0xffffffffu, x, 31);
      }
    }
    __syncthreads();
    if (ent >= 0) before_ent = acc_before(bal, before, ent);
  }

  if (ent >= 0) {
    const i64 it = it0 + before_ent;
    if (own_it) a.entry_it[ent] = it;
    else v = (T)it;
  }
  if (dst) *dst = v;
}

template <typename T>
__global__ void __launch_bounds__(BLOCK) assemble_refill(Args a) {
  const int s = blockIdx.x * BLOCK + threadIdx.x;
  if (s >= a.nlive) return;
  // the birth loaded beside the mark: the row's loads wait on the mark
  const int m = a.mark[s];
  const T birth = *(const T*)a.birth;
  a.last[s] = (i64)m - 1;
  if (m == 0) return;
  a.mark[s] = 0;
  const i64 src = m - 1;
  const int il = a.ndim + a.npdim;
  T* row = (T*)a.live + (i64)s * (il + 4);
  const i64 it = a.entry_it[src];
  copy_values(row, (const T*)a.qrows + src * a.rs, il + 1);
  row[il + 1] = (T)it;
  row[il + 2] = (T)-1;
  row[il + 3] = birth;
}

template <typename T>
int launch(void* const* p, int q, int nlive, int ndim, int npdim, int rs,
           int ls, void* stream) {
  if (q < 1 || nlive < 1 || ndim < 1 || npdim < 0 ||
      rs < ndim + npdim + 1 || ls < 2)
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < N_PTR; ++k)
    if (!p[k] && k != P_RIDX) return (int)cudaErrorInvalidValue;
  Args a;
  a.worsts = (const i64*)p[0]; a.srcs = (const i64*)p[1];
  a.accepts = (const bool*)p[2];
  a.r_logl = p[3]; a.r_logvol = p[4]; a.r_logwt = p[5]; a.r_logz = p[6];
  a.r_logzvar = p[7]; a.r_h = p[8]; a.r_nc = (const i64*)p[9];
  a.r_dlogz = p[10]; a.r_n = p[11];
  a.live = p[12]; a.qrows = p[13]; a.qnc = (const i64*)p[14];
  a.lane = p[15]; a.it0 = (const i64*)p[16]; a.birth = p[17];
  a.threshold = p[18]; a.ridx = (const i64*)p[P_RIDX];
  a.recs = p[20]; a.props = p[21]; a.acc = p[22]; a.dlogz = p[23];
  a.lane_out = p[24]; a.thr = p[25];
  a.entry_it = (i64*)p[26]; a.last = (i64*)p[27]; a.mark = (int*)p[28];
  a.q = q; a.nlive = nlive; a.ndim = ndim; a.npdim = npdim; a.rs = rs;
  a.ls = ls;
  const int il = ndim + npdim;
  const i64 total = (i64)q * ((il + 12) + (il + 4) + 4);
  if (total > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const i64 blocks = (total + BLOCK - 1) / BLOCK;
  // shared memory only past 32 words of accepts
  const size_t smem = q > 32 * 32 ? (size_t)((q + 31) / 32) * 8 : 0;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        assemble_records<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  assemble_records<T><<<(unsigned)blocks, BLOCK, smem,
                        (cudaStream_t)stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  assemble_refill<T><<<(nlive + BLOCK - 1) / BLOCK, BLOCK, 0,
                       (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// p: the operands' pointers in the order of Args (ops/consume.py)
#define ASSEMBLE_ENTRY(TAG, T)                                              \
  extern "C" int dynesty_round_assemble_##TAG(                              \
      void* const* p, int q, int nlive, int ndim, int npdim, int rs,        \
      int ls, void* stream) {                                               \
    return launch<T>(p, q, nlive, ndim, npdim, rs, ls, stream);             \
  }

ASSEMBLE_ENTRY(f64, double)
ASSEMBLE_ENTRY(f32, float)
