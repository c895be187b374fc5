// Batched float32 products with one shared matrix, hand-written for Hopper
// (sm_90a): the band-matrix formulation of the Laplacian pyramid.
//
// Replaces the Pallas TPU kernel laplacian_band_levels_mm of
// respmon_tpu/ops/pyramid_pallas.py (:186-223, body _make_matmul_kernel
// :157-182). That kernel computes every pyrDown and pyrUp axis pass of a
// frame as a dense product with a band matrix, in its own body, at full
// float32: gauss[i+1] = D_h * gauss[i] * D_w^T, up = U_h * gauss[l+1] * U_w^T,
// out = gauss[l] - up. Here the same chain is two entry points, composed in
// ops/pyramid_mm.py:
//   band_left_f32 :  C[t] = A * B[t]                  A (m,k), B (T,k,n)
//   band_right_f32:  C[t] = B[t] * A  or  M[t] - B[t] * A
//                                                     B (T,m,k), A (k,n)
// The products are computed here, by FFMA on CUDA cores, not by a library:
// no tensor cores (a TF32 product loses ~1e-3 absolute, the bar is 1e-5).
//
// Bound: the bytes that must move (every operand read once, the output
// written once): the matrices have at most 5 nonzeros a row, so the
// operations the data needs are few and the function, like the pyramid of
// csrc/pyramid.cu, is bound by device memory. The dense product computed
// here does ~100 times those operations (~42 GFLOP for the chain at
// (128,480,640) with 9 levels), which is what its time follows.
//
// The design is the
// plain shared-memory tiling: a block computes a 64x64 tile of one frame's
// output, walks the inner dimension in slabs of 16 staged through shared
// memory, and each of its 256 threads keeps a 4x4 register tile, so every
// value fetched from shared memory feeds 4 FFMAs. The shared matrix is read
// again by every frame's blocks and stays in L2. Ragged edges are loaded as
// zeros and masked at the store. Exploiting the band (only the slabs that
// hold a row's nonzeros) or moving to wgmma with a split-float32 scheme is
// later work.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;      // output tile is kTile x kTile
constexpr int kSlab = 16;      // inner-dimension slab
constexpr int kMicro = 4;      // each thread owns kMicro x kMicro outputs
constexpr int kThreads = (kTile / kMicro) * (kTile / kMicro);  // 256
constexpr int kMaxGridZ = 65535;

// C[t] = X[t] * Y[t] (or M[t] - X[t] * Y[t]); X is (m,k), Y is (k,n), all
// row-major. A stride of 0 shares one matrix between all frames.
__global__ void __launch_bounds__(kThreads)
band_product_kernel(const float* __restrict__ X, long long stride_x,
                    const float* __restrict__ Y, long long stride_y,
                    const float* __restrict__ minuend, float* __restrict__ C,
                    int T, int m, int k, int n) {
  // The X slab is stored transposed (+1 padding against bank conflicts) so
  // that the inner loop reads rows of both slabs.
  __shared__ float xs[kSlab][kTile + 1];
  __shared__ float ys[kSlab][kTile];

  const int tid = threadIdx.x;
  const int tx = tid % (kTile / kMicro);
  const int ty = tid / (kTile / kMicro);
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  const long long plane = (long long)m * n;

  for (int t = blockIdx.z; t < T; t += gridDim.z) {
    const float* x = X + t * stride_x;
    const float* y = Y + t * stride_y;
    float acc[kMicro][kMicro];
#pragma unroll
    for (int i = 0; i < kMicro; ++i)
#pragma unroll
      for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < k; k0 += kSlab) {
#pragma unroll
      for (int i = 0; i < kTile * kSlab / kThreads; ++i) {
        const int e = tid + i * kThreads;
        const int r = e / kSlab, c = e % kSlab;
        const int gr = row0 + r, gc = k0 + c;
        xs[c][r] = (gr < m && gc < k) ? x[(long long)gr * k + gc] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kSlab * kTile / kThreads; ++i) {
        const int e = tid + i * kThreads;
        const int r = e / kTile, c = e % kTile;
        const int gr = k0 + r, gc = col0 + c;
        ys[r][c] = (gr < k && gc < n) ? y[(long long)gr * n + gc] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kSlab; ++kk) {
        float a[kMicro], b[kMicro];
#pragma unroll
        for (int i = 0; i < kMicro; ++i) a[i] = xs[kk][ty * kMicro + i];
#pragma unroll
        for (int j = 0; j < kMicro; ++j) b[j] = ys[kk][tx * kMicro + j];
#pragma unroll
        for (int i = 0; i < kMicro; ++i)
#pragma unroll
          for (int j = 0; j < kMicro; ++j)
            acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < kMicro; ++i) {
      const int r = row0 + ty * kMicro + i;
      if (r >= m) continue;
#pragma unroll
      for (int j = 0; j < kMicro; ++j) {
        const int c = col0 + tx * kMicro + j;
        if (c >= n) continue;
        const long long o = t * plane + (long long)r * n + c;
        C[o] = minuend != nullptr ? minuend[o] - acc[i][j] : acc[i][j];
      }
    }
  }
}

int launch(const float* X, long long stride_x, const float* Y,
           long long stride_y, const float* minuend, float* C, int T, int m,
           int k, int n, void* stream) {
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile,
                  T < kMaxGridZ ? T : kMaxGridZ);
  band_product_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      X, stride_x, Y, stride_y, minuend, C, T, m, k, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface (loaded with ctypes). Each returns the cudaError_t of its
// launch; the caller allocates every buffer and passes its current stream.

// C[t] = A * B[t]: A is (m,k), B is (T,k,n), C is (T,m,n).
extern "C" int band_left_f32(const float* A, const float* B, float* C, int T,
                             int m, int k, int n, void* stream) {
  return launch(A, 0, B, (long long)k * n, nullptr, C, T, m, k, n, stream);
}

// C[t] = B[t] * A, or minuend[t] - B[t] * A when minuend is not null:
// B is (T,m,k), A is (k,n), minuend and C are (T,m,n).
extern "C" int band_right_f32(const float* B, const float* A,
                              const float* minuend, float* C, int T, int m,
                              int k, int n, void* stream) {
  return launch(B, (long long)m * k, A, 0, minuend, C, T, m, k, n, stream);
}
