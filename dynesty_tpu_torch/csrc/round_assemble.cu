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
//   assemble_records, one block: the prefix sum of the accepts in chunks
//     of the block (entry_it = it0 + the accepts before each entry, kept in
//     a scratch vector), then a thread an entry writes the round's record
//     row, its proposals row, its accept (0 or 1 in the float type), its
//     delta_logz and lane stats into the dispatch's buffers at the round's
//     offset (ridx * q rows, ridx read from the device), and the round's
//     threshold.  The record reads the live row of a dead original, so the
//     live matrix must not change before this kernel ends.
//   assemble_refill, a thread a live slot: the last entry accepted into
//     the slot (a scan of the q entries, as the eager scatter_reduce amax),
//     written to `last` (-1: kept), and the slot's row refilled from that
//     proposal: u, v, logl, entry_it, bound -1, birth.
//
// What bounds it on this card: nothing the card measures.  At (2048, 256)
// and 3 dimensions a round moves ~60 kB (~18 ns at 3.35 TB/s); two
// launches cost ~2 us.  The design answer is the one launch pair that
// takes the host's ~40 launches off the round and, since every operand is
// a device pointer (the round's index too), lets the whole round's
// epilogue be one CUDA graph replay (internal/fused.py).
//
// Rounding: only copies, integer sums and exact conversions (an int64 to
// the float type, as torch's .to()).

#include <cuda_runtime.h>
#include <stdint.h>

typedef long long i64;

namespace {

const int BLOCK = 256;
// the pointer table's length, and the one entry that may be null
const int N_PTR = 28, P_RIDX = 19;

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
  int q, nlive, ndim, npdim, rs, ls;
};

template <typename T>
__global__ void __launch_bounds__(BLOCK) assemble_records(Args a) {
  __shared__ i64 scan[BLOCK];
  const int t = threadIdx.x;
  const int q = a.q, ndim = a.ndim, npdim = a.npdim;
  const int il = ndim + npdim, lw = il + 4, w = il + 12, pw = il + 4;
  const i64 it0 = *a.it0;
  const i64 r = a.ridx ? *a.ridx : 0;

  // entry_it = it0 + (accepts before the entry), chunk by chunk
  i64 carry = 0;
  for (int base = 0; base < q; base += BLOCK) {
    const int i = base + t;
    const i64 v = (i < q && a.accepts[i]) ? 1 : 0;
    scan[t] = v;
    __syncthreads();
    for (int off = 1; off < BLOCK; off <<= 1) {
      const i64 x = t >= off ? scan[t - off] : 0;
      __syncthreads();
      scan[t] += x;
      __syncthreads();
    }
    if (i < q) a.entry_it[i] = it0 + carry + scan[t] - v;
    carry += scan[BLOCK - 1];
    __syncthreads();
  }

  const T* live = (const T*)a.live;
  const T* qrows = (const T*)a.qrows;
  const T* lane = (const T*)a.lane;
  const T birth = *(const T*)a.birth;
  const T* cols[6] = {(const T*)a.r_logl, (const T*)a.r_logvol,
                      (const T*)a.r_logwt, (const T*)a.r_logz,
                      (const T*)a.r_logzvar, (const T*)a.r_h};
  for (int i = t; i < q; i += BLOCK) {
    const i64 wst = a.worsts[i], src = a.srcs[i];
    const bool orig = src < 0;
    const i64 sc = orig ? 0 : src;
    const T* lrow = live + wst * lw;
    const T* prow = qrows + sc * (i64)a.rs;
    const i64 row = r * q + i;
    T* rec = (T*)a.recs + row * w;
    rec[0] = (T)wst;
    for (int d = 0; d < il; ++d) rec[1 + d] = orig ? lrow[d] : prow[d];
    T* c = rec + 1 + il;
    for (int k = 0; k < 6; ++k) c[k] = cols[k][i];
    c[6] = (T)a.r_nc[i];
    c[7] = orig ? lrow[il + 1] : (T)a.entry_it[sc];
    c[8] = orig ? lrow[il + 2] : (T)-1;
    c[9] = ((const T*)a.r_n)[i];
    c[10] = orig ? lrow[il + 3] : birth;

    const T* qi = qrows + (i64)i * a.rs;
    T* pr = (T*)a.props + row * pw;
    for (int d = 0; d <= il; ++d) pr[d] = qi[d];
    pr[il + 1] = (T)a.qnc[i];
    const T l0 = lane[(i64)i * a.ls], l1 = lane[(i64)i * a.ls + 1];
    pr[il + 2] = l0;
    pr[il + 3] = l1;
    ((T*)a.acc)[row] = a.accepts[i] ? (T)1 : (T)0;
    ((T*)a.dlogz)[row] = ((const T*)a.r_dlogz)[i];
    ((T*)a.lane_out)[2 * row] = l0;
    ((T*)a.lane_out)[2 * row + 1] = l1;
  }
  if (t == 0) ((T*)a.thr)[r] = *(const T*)a.threshold;
}

template <typename T>
__global__ void __launch_bounds__(BLOCK) assemble_refill(Args a) {
  const int s = blockIdx.x * BLOCK + threadIdx.x;
  if (s >= a.nlive) return;
  i64 last = -1;
  for (int i = 0; i < a.q; ++i)
    if (a.accepts[i] && a.worsts[i] == s) last = i;
  a.last[s] = last;
  if (last < 0) return;
  const int il = a.ndim + a.npdim;
  T* row = (T*)a.live + (i64)s * (il + 4);
  const T* qi = (const T*)a.qrows + last * (i64)a.rs;
  for (int d = 0; d <= il; ++d) row[d] = qi[d];
  row[il + 1] = (T)a.entry_it[last];
  row[il + 2] = (T)-1;
  row[il + 3] = *(const T*)a.birth;
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
  a.entry_it = (i64*)p[26]; a.last = (i64*)p[27];
  a.q = q; a.nlive = nlive; a.ndim = ndim; a.npdim = npdim; a.rs = rs;
  a.ls = ls;
  assemble_records<T><<<1, BLOCK, 0, (cudaStream_t)stream>>>(a);
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
