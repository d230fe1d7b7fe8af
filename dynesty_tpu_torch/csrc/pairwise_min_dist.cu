// Leave-one-out nearest-neighbour distance of each of N points (L2 for the
// RadFriends radius, L-inf for SupFriends), for the friends bounds.
//
// Replaces dynesty_tpu/ops/pallas_kernels.py:_min_dist_kernel_l2 (the
// MXU-tiled |a|^2 + |b|^2 - 2 a.b Pallas kernel) and, for p = inf, the jnp
// reference that the JAX package runs for cubes.  Output: (N,) float32, the
// exact leave-one-out minimum; the self pair is excluded by global index and
// the ragged edge is masked.  Every entry point expects `out` filled with
// +inf by the caller.
//
// What bounds it on an H100: N^2 * d pair-coordinate terms.  The bytes
// (N * d floats in, N out) are a few MB at most and stay in L2, so it is
// bound by operations: on fp32 CUDA cores for the exact form (a sub and an
// FMA, or a sub and a max, per term), on the tensor cores for the expansion
// form.  Two paths; the wrapper (ops/hopper_kernels.py) picks one:
//
// Path A, exact differences on CUDA cores (small N * d, and every p = inf).
//   A 2-D grid of row tiles x column splits, sized to the blocks the card
//   holds at once, fills it even at N = 2048 (16 x 16 blocks).  Each of
//   the 256 threads holds an 8 x 8 block of pairs in registers, so one
//   value read from shared memory feeds 8 terms.  d is walked in chunks
//   of a compile-time width DC (4, 8 or 16, zero-padded: (0 - 0) adds
//   nothing to a sum or a max), so any d works.  The metric is a template
//   parameter.
//
// Path B, 3xTF32 wgmma on the expansion form (large N * d, d <= 128).
//   A prologue centres the points (the friends refit passes whitened but
//   uncentred points, whose |a|^2 would swamp the distance), zero-pads the
//   rows to a multiple of 32, splits each value x = hi + lo into two tf32
//   and takes the squared norms.  Two warpgroups per block each own 64 rows
//   of a 128-row tile; wgmma.m64n128k8 forms a . b from shared memory
//   (K-major, 128-byte swizzle) as lo*hi + hi*lo + hi*hi in fp32, which
//   drops only lo*lo (about 2^-22 |a||b|).  The row tile stays resident;
//   the column tiles stream through a three-stage cp.async ring.  The
//   epilogue stays in registers: |b|^2 - 2 a.b, the self pair masked on
//   the diagonal tile, a tree minimum per row, and the column of the
//   best (ties to the smaller index); the N x N matrix never reaches device
//   memory.  Each block then re-ranks its best candidate by exact fp32
//   differences of the original points, so what it publishes is a true
//   distance to a real neighbour.  Error bound: with e the absolute error
//   of the expansion in a squared distance (a few eps32 * (|a|^2 + |b|^2)
//   after centring), the result lies in [D, sqrt(D^2 + 2 e)], D the exact
//   minimum; it differs from D only where another candidate ties D^2 to
//   within 2 e.
//
// Column splits are combined with atomicMin on the bits of the float: for
// values >= 0 IEEE order is integer order, and sqrt is monotone, so each
// block publishes its final value.  A minimum does not depend on the order
// of the atomics, so the result is deterministic; a cluster reduction
// through distributed shared memory would tie the split count to the
// cluster size (at most 8 portable), where atomics let it follow N.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Split the column tiles so that the grid holds about the blocks that can
// be resident at once (`capacity`).  Returns the split count; `per` is
// column tiles per split.
int column_splits(int row_tiles, int col_tiles, int capacity, int* per) {
  const int want = std::min(col_tiles, std::max(1, capacity / row_tiles));
  *per = ceil_div(col_tiles, want);
  return ceil_div(col_tiles, *per);
}

// Blocks of `kernel` resident on the whole card at once.
template <typename K>
int capacity(K kernel, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                smem);
  return std::max(1, sms * per_sm);
}

__device__ __forceinline__ void publish_min(float* out, float v) {
  atomicMin(reinterpret_cast<int*>(out), __float_as_int(v));
}

// ---------------------------------------------------------------- path A

template <int TM, int TN, int DC, bool LINF>
__global__ void __launch_bounds__(kThreads)
exact_kernel(const float* __restrict__ pts, float* __restrict__ out, int n,
             int d, int tiles_per_split) {
  constexpr int BM = 16 * TM;
  constexpr int BN = 16 * TN;
  // +4: a warp's transposing stores hit 32 distinct banks; rows stay
  // 16-byte aligned for the float4 reads
  __shared__ __align__(16) float as[DC][BM + 4];
  __shared__ __align__(16) float bs[DC][BN + 4];
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int row0 = blockIdx.x * BM;
  const int col_tiles = (n + BN - 1) / BN;
  const int ct0 = blockIdx.y * tiles_per_split;
  const int ct1 = min(col_tiles, ct0 + tiles_per_split);
  const bool rows_once = d <= DC;  // one chunk: the row tile never changes

  float best[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) best[i] = CUDART_INF_F;

  for (int ct = ct0; ct < ct1; ++ct) {
    const int col0 = ct * BN;
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
    }
    for (int k0 = 0; k0 < d; k0 += DC) {
      __syncthreads();  // every thread is done with the previous chunk
      if (!rows_once || ct == ct0) {
        for (int e = threadIdx.x; e < BM * DC; e += kThreads) {
          const int r = e / DC;
          const int k = e - r * DC;
          const int gr = row0 + r;
          const int gk = k0 + k;
          as[k][r] = (gr < n && gk < d)
                         ? pts[static_cast<size_t>(gr) * d + gk] : 0.0f;
        }
      }
      for (int e = threadIdx.x; e < BN * DC; e += kThreads) {
        const int c = e / DC;
        const int k = e - c * DC;
        const int gc = col0 + c;
        const int gk = k0 + k;
        bs[k][c] = (gc < n && gk < d)
                       ? pts[static_cast<size_t>(gc) * d + gk] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < DC; ++k) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; i += 4) {
          const float4 v =
              *reinterpret_cast<const float4*>(&as[k][ty * TM + i]);
          a[i] = v.x; a[i + 1] = v.y; a[i + 2] = v.z; a[i + 3] = v.w;
        }
#pragma unroll
        for (int j = 0; j < TN; j += 4) {
          const float4 v =
              *reinterpret_cast<const float4*>(&bs[k][tx * TN + j]);
          b[j] = v.x; b[j + 1] = v.y; b[j + 2] = v.z; b[j + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            const float t = a[i] - b[j];
            if (LINF) {
              acc[i][j] = fmaxf(acc[i][j], fabsf(t));
            } else {
              acc[i][j] = fmaf(t, t, acc[i][j]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int gr = row0 + ty * TM + i;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int gc = col0 + tx * TN + j;
        if (gc < n && gc != gr) best[i] = fminf(best[i], acc[i][j]);
      }
    }
  }
  // the 16 threads of one row group are 16 neighbouring lanes of a warp
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      best[i] = fminf(best[i], __shfl_xor_sync(0xffffffffu, best[i], off));
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int gr = row0 + ty * TM + i;
      if (gr < n) publish_min(&out[gr], LINF ? best[i] : sqrtf(best[i]));
    }
  }
}

template <int TM, int TN, int DC, bool LINF>
int launch_exact(const float* pts, float* out, int n, int d,
                 cudaStream_t stream) {
  const int row_tiles = ceil_div(n, 16 * TM);
  const int col_tiles = ceil_div(n, 16 * TN);
  static const int cap = capacity(exact_kernel<TM, TN, DC, LINF>, 0);
  int per = 1;
  const int splits = column_splits(row_tiles, col_tiles, cap, &per);
  exact_kernel<TM, TN, DC, LINF>
      <<<dim3(row_tiles, splits), kThreads, 0, stream>>>(pts, out, n, d, per);
  return static_cast<int>(cudaGetLastError());
}

// An 8 x 8 register block per thread (128 x 128 block tiles) measured as
// fast as or faster than 4 x 4 from N = 2048 up (PERF.md).
template <bool LINF>
int launch_exact_any(const float* pts, float* out, int n, int d,
                     cudaStream_t s) {
  if (d <= 4) return launch_exact<8, 8, 4, LINF>(pts, out, n, d, s);
  if (d <= 8) return launch_exact<8, 8, 8, LINF>(pts, out, n, d, s);
  return launch_exact<8, 8, 16, LINF>(pts, out, n, d, s);
}

// ---------------------------------------------------------------- path B

constexpr int kTcBM = 128;  // rows of a block tile
constexpr int kTcBN = 128;  // columns of a block tile
// K-major tf32 operands in the 128-byte swizzle: one row of a block is 32
// values (128 bytes), 8 rows form a 1 KB atom, and the 16-byte unit q of
// row r sits at unit q ^ (r % 8).  A block holds 128 rows x 32 k (16 KB).
constexpr int kTcBK = 32;
constexpr int kTcStages = 3;
constexpr int kTcBlock = kTcBM * kTcBK * 4;
// the resident row tile (hi and lo) and the ring fit the 227 KB a block
// may hold up to this padded width
constexpr int kTcMaxD = 128;

size_t tc_smem_bytes(int dpad) {
  // + 1 KB to align the atoms
  return 1024 + static_cast<size_t>(kTcBlock) *
                    (2 * (dpad / kTcBK) + 2 * kTcStages);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// Round to the nearest tf32 (ties away from zero) with two integer ops.
__device__ __forceinline__ uint32_t round_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void keep_better(float& v, int& i, float ov,
                                            int oi) {
  if (ov < v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// Epilogue of one row of a tile: `v` holds |b|^2 - 2 a.b of this thread's
// N columns of the row (self pair and ragged edge already +inf), in
// increasing column order, col(k) their indices.  The minimum is a tree
// (no serial compare chain); the index is searched only when the row's
// running best improves, which is rare after the first tiles.  Ties keep
// the smaller column, as a strict < over increasing columns would.
template <int N, typename Col>
__device__ __forceinline__ void row_best(const float (&v)[N], Col col,
                                         float& best_v, int& best_i) {
  float m[4] = {v[0], v[1], v[2], v[3]};
#pragma unroll
  for (int k = 4; k < N; ++k) m[k & 3] = fminf(m[k & 3], v[k]);
  const float mm = fminf(fminf(m[0], m[1]), fminf(m[2], m[3]));
  if (mm < best_v) {
    int at = 0;
#pragma unroll
    for (int k = N - 1; k >= 0; --k) {
      if (v[k] == mm) at = k;
    }
    best_v = mm;
    best_i = col(at);
  }
}

__device__ __forceinline__ int sw128(int r, int q) {
  return r * 128 + ((q ^ (r & 7)) << 4);
}

// descriptor of a swizzled K-major tile: row groups of 8 are 1 KB apart
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a >> 4) & 0x3FFFu) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// D (64 x 128, f32) (+)= A (64 x 8) . B (128 x 8)^T, both tf32 in shared
// memory, K-major.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void pin(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// One warp per row, lanes along the coordinates.
__global__ void split_norm_kernel(const float* __restrict__ pts,
                                  const float* __restrict__ mean,
                                  float* __restrict__ hi,
                                  float* __restrict__ lo,
                                  float* __restrict__ norms, int n, int d,
                                  int dpad) {
  const int row = blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  float s = 0.0f;
  for (int k = lane; k < dpad; k += 32) {
    const float v = k < d ? pts[static_cast<size_t>(row) * d + k] - mean[k]
                          : 0.0f;
    const float h = __uint_as_float(round_tf32(v));
    hi[static_cast<size_t>(row) * dpad + k] = h;
    lo[static_cast<size_t>(row) * dpad + k] =
        __uint_as_float(round_tf32(v - h));
    s = fmaf(v, v, s);
  }
  s = warp_sum(s);
  if (lane == 0) norms[row] = s;
}

// 2 warpgroups; each owns 64 rows of the 128-row tile and all 128 columns
// of a column tile.  hi/lo of the row tile stay resident; hi/lo chunks of
// the column tiles stream through the cp.async ring.  The accumulator
// layout of m64nN: warp w of the warpgroup holds rows 16 w + g and
// 16 w + g + 8 (g = lane / 4) of columns 8 j + 2 t, 8 j + 2 t + 1 (t =
// lane % 4) at acc[4 j + 2 h + e].
__global__ void __launch_bounds__(kThreads, 1)
tc_kernel(const float* __restrict__ pts, const float* __restrict__ xhi,
          const float* __restrict__ xlo, const float* __restrict__ norms,
          float* __restrict__ out, int n, int d, int dpad,
          int tiles_per_split) {
  extern __shared__ __align__(128) unsigned char wsm[];
  const int ablocks = dpad / kTcBK;
  unsigned char* a_hi = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(wsm) + 1023) & ~uintptr_t(1023));
  unsigned char* a_lo = a_hi + ablocks * kTcBlock;
  unsigned char* ring = a_lo + ablocks * kTcBlock;  // [stage][hi, lo]
  const int stage_bytes = 2 * kTcBlock;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wg = warp >> 2;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = blockIdx.x * kTcBM;
  const int col_tiles = (n + kTcBN - 1) / kTcBN;
  const int ct0 = blockIdx.y * tiles_per_split;
  const int ct1 = min(col_tiles, ct0 + tiles_per_split);
  const int nk = (dpad + kTcBK - 1) / kTcBK;
  const int stages = (ct1 - ct0) * nk;

  auto copy16 = [](unsigned char* dst, const float* src, bool valid) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(valid ? 16 : 0));
  };
  auto issue = [&](int s) {
    const int col0 = (ct0 + s / nk) * kTcBN;
    const int k0 = (s % nk) * kTcBK;
    unsigned char* hi = ring + (s % kTcStages) * stage_bytes;
    unsigned char* lo = hi + kTcBlock;
    for (int e = threadIdx.x; e < kTcBN * (kTcBK / 4); e += kThreads) {
      const int c = e / (kTcBK / 4);
      const int q = e % (kTcBK / 4);
      const int gc = col0 + c;
      const bool valid = gc < n;
      const size_t off =
          valid ? static_cast<size_t>(gc) * dpad + k0 + 4 * q : 0;
      const int o = sw128(c, q);
      copy16(hi + o, xhi + off, valid);
      copy16(lo + o, xlo + off, valid);
    }
    asm volatile("cp.async.commit_group;\n");
  };

  // the row tile, into group 0 with the first chunk
  for (int e = threadIdx.x; e < kTcBM * (dpad / 4); e += kThreads) {
    const int r = e / (dpad / 4);
    const int q = e % (dpad / 4);
    const int gr = row0 + r;
    const size_t off = gr < n ? static_cast<size_t>(gr) * dpad + 4 * q : 0;
    const int o = (q / 8) * kTcBlock + sw128(r, q % 8);
    copy16(a_hi + o, xhi + off, gr < n);
    copy16(a_lo + o, xlo + off, gr < n);
  }
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < stages) {
      issue(s);
    } else {
      asm volatile("cp.async.commit_group;\n");
    }
  }

  float best_v[2] = {CUDART_INF_F, CUDART_INF_F};
  int best_i[2] = {-1, -1};
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  const int wrow = wg * 64;  // this warpgroup's rows within the tile

  for (int s = 0; s < stages; ++s) {
    // the buffer of stage s + 2 last held stage s - 1, done by every warp
    if (s + kTcStages - 1 < stages) {
      issue(s + kTcStages - 1);
    } else {
      asm volatile("cp.async.commit_group;\n");
    }
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kTcStages - 1)
                 : "memory");
    // cp.async wrote through the generic proxy; wgmma reads through the
    // async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const int kc = s % nk;
    const unsigned char* bhi = ring + (s % kTcStages) * stage_bytes;
    const unsigned char* blo = bhi + kTcBlock;
    const int ao = kc * kTcBlock + wrow * 128;
    pin(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kTcBK; kk += 8) {
      // a k8 step is 32 bytes further along the (swizzled) rows
      const uint64_t dah = smem_desc(a_hi + ao + kk * 4);
      const uint64_t dal = smem_desc(a_lo + ao + kk * 4);
      const uint64_t dbh = smem_desc(bhi + kk * 4);
      const uint64_t dbl = smem_desc(blo + kk * 4);
      // small terms first; the first product of a tile overwrites
      wgmma_tf32(acc, dal, dbh, kc > 0 || kk > 0);
      wgmma_tf32(acc, dah, dbl, 1);
      wgmma_tf32(acc, dah, dbh, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    pin(acc);
    if (kc == nk - 1) {
      // columns c0 + 8 j + e sit at acc[4 j + 2 h + e] for rows r0 + 8 h
      const int c0 = (ct0 + s / nk) * kTcBN + 2 * t;
      const int r0 = row0 + wrow + (warp & 3) * 16 + g;
      float2 nc[16];  // norms of columns c0 + 8 j, c0 + 8 j + 1
      if (c0 - 2 * t + kTcBN <= n) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          nc[j] = *reinterpret_cast<const float2*>(norms + c0 + 8 * j);
        }
      } else {  // the ragged edge: +inf past n
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int gc = c0 + 8 * j;
          nc[j].x = gc < n ? norms[gc] : CUDART_INF_F;
          nc[j].y = gc + 1 < n ? norms[gc + 1] : CUDART_INF_F;
        }
      }
      const bool diag = c0 - 2 * t == row0;  // the tile of the self pairs
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[32];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          v[2 * j] = fmaf(-2.0f, acc[4 * j + 2 * h], nc[j].x);
          v[2 * j + 1] = fmaf(-2.0f, acc[4 * j + 2 * h + 1], nc[j].y);
        }
        if (diag) {
#pragma unroll
          for (int k = 0; k < 32; ++k) {
            if (c0 + 8 * (k >> 1) + (k & 1) == r0 + 8 * h) {
              v[k] = CUDART_INF_F;
            }
          }
        }
        row_best(v, [&](int k) { return c0 + 8 * (k >> 1) + (k & 1); },
                 best_v[h], best_i[h]);
      }
    }
    __syncthreads();  // every warp is done with the buffer of stage s
  }

  // the 4 lanes that share a row; then an exact re-rank per row
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best_v[h], off);
      const int oi = __shfl_xor_sync(0xffffffffu, best_i[h], off);
      keep_better(best_v[h], best_i[h], ov, oi);
    }
    const int gr = row0 + wrow + (warp & 3) * 16 + g + 8 * h;
    if (t == 0 && gr < n && best_i[h] >= 0) {
      const float* a = pts + static_cast<size_t>(gr) * d;
      const float* b = pts + static_cast<size_t>(best_i[h]) * d;
      float sum = 0.0f;
      for (int k = 0; k < d; ++k) {
        const float dk = a[k] - b[k];
        sum = fmaf(dk, dk, sum);
      }
      publish_min(&out[gr], sqrtf(sum));
    }
  }
}

}  // namespace

// pts: (n, d) float32 row-major on the device; out: (n,) float32 filled
// with +inf.  linf != 0 takes max |a - b|, else the Euclidean distance.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int dynesty_pairwise_min_dist_exact(const float* pts, float* out,
                                               int n, int d, int linf,
                                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 2 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  return linf ? launch_exact_any<true>(pts, out, n, d, s)
              : launch_exact_any<false>(pts, out, n, d, s);
}

// Euclidean distances through the tensor cores.  pts: (n, d); mean: (d,)
// the mean of pts; hi, lo: (n, dpad) and norms: (n,) scratch written here
// (dpad a multiple of 32, d <= dpad <= 128); out: (n,) filled with +inf.
extern "C" int dynesty_pairwise_min_dist_tc(const float* pts,
                                            const float* mean, float* hi,
                                            float* lo, float* norms,
                                            float* out, int n, int d,
                                            int dpad, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 2 || d < 1 || dpad < d || dpad % kTcBK != 0 || dpad > kTcMaxD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  split_norm_kernel<<<ceil_div(n, 8), 256, 0, s>>>(pts, mean, hi, lo,
                                                   norms, n, d, dpad);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  // above 48 KB of dynamic shared memory only after this opt-in
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(tc_smem_bytes(kTcMaxD)));
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const size_t smem = tc_smem_bytes(dpad);
  const int row_tiles = ceil_div(n, kTcBM);
  const int col_tiles = ceil_div(n, kTcBN);
  int per = 1;
  const int splits = column_splits(row_tiles, col_tiles,
                                   capacity(tc_kernel, smem), &per);
  tc_kernel<<<dim3(row_tiles, splits), kThreads, smem, s>>>(
      pts, hi, lo, norms, out, n, d, dpad, per);
  return static_cast<int>(cudaGetLastError());
}
