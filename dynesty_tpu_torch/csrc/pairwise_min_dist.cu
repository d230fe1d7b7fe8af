// Leave-one-out nearest-neighbour Euclidean distance of each of N points,
// for the radius of the RadFriends bound.
//
// Replaces dynesty_tpu/ops/pallas_kernels.py:_min_dist_kernel_l2 (the
// MXU-tiled |a|^2 + |b|^2 - 2 a.b Pallas kernel).  What bounds it on an
// H100: N^2 * d fused multiply-adds on float32 CUDA cores; the bytes
// (N * d floats in, N out) are negligible, so it is compute-bound.  This
// design is the simple correct one: one thread per query row, its
// coordinates held in registers; the point set streams through shared
// memory in tiles of 128 columns that every thread of the block reads by
// broadcast; squared differences are accumulated exactly (no expansion,
// hence no cancellation and no need to centre the points); the self pair
// is excluded by global index; the ragged edge is masked rather than
// padded.  The dimension is padded with zeros to a compile-time width
// (4..64), which adds (0 - 0)^2 = 0 to every sum.  Tensor cores (mma or
// wgmma on the expansion form) are the next step for speed.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kRows = 128;  // threads per block, one query row each
constexpr int kTile = 128;  // candidate columns staged per shared tile

template <int DP>
__global__ void __launch_bounds__(kRows)
min_dist_l2_kernel(const float* __restrict__ pts, float* __restrict__ out,
                   int n, int d) {
  __shared__ float tile[kTile * DP];
  const int row = blockIdx.x * kRows + threadIdx.x;
  float a[DP];
#pragma unroll
  for (int k = 0; k < DP; ++k) {
    a[k] = (row < n && k < d) ? pts[static_cast<size_t>(row) * d + k] : 0.0f;
  }
  float best = CUDART_INF_F;
  for (int c0 = 0; c0 < n; c0 += kTile) {
    const int nc = min(kTile, n - c0);
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < kTile * DP; i += kRows) {
      const int j = i / DP;
      const int k = i - j * DP;
      tile[i] = (j < nc && k < d)
                    ? pts[static_cast<size_t>(c0 + j) * d + k]
                    : 0.0f;
    }
    __syncthreads();
    for (int j = 0; j < nc; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < DP; ++k) {
        const float t = a[k] - tile[j * DP + k];
        s = fmaf(t, t, s);
      }
      if (c0 + j != row) best = fminf(best, s);
    }
  }
  if (row < n) out[row] = sqrtf(best);
}

template <int DP>
int launch(const float* pts, float* out, int n, int d, cudaStream_t stream) {
  const dim3 grid((n + kRows - 1) / kRows);
  min_dist_l2_kernel<DP><<<grid, kRows, 0, stream>>>(pts, out, n, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pts: (n, d) float32 row-major on the device; out: (n,) float32.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int dynesty_pairwise_min_dist_l2(const float* pts, float* out,
                                            int n, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 2 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (d <= 4) return launch<4>(pts, out, n, d, s);
  if (d <= 8) return launch<8>(pts, out, n, d, s);
  if (d <= 16) return launch<16>(pts, out, n, d, s);
  if (d <= 32) return launch<32>(pts, out, n, d, s);
  if (d <= 64) return launch<64>(pts, out, n, d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
