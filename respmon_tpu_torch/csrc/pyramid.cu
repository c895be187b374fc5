// Pyramid kernels of the EVM calibration, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of respmon_tpu/ops/pyramid_pallas.py:
//   - laplacian_band_levels (K1, :294-321): the per-frame Gaussian chain and
//     the kept Laplacian levels. Here: levels-1 launches of pyr_down_f32, then
//     one lap_level_f32 per kept level (composed in ops/pyramid_cuda.py).
//   - gauss_level_tiled (K2, :244-291): a Gaussian level of a frame too large
//     for TPU VMEM, computed over halo'd W-strips. Hopper tiles by thread
//     block, so there are no strips: K2 is s1 launches of pyr_down_f32.
//
// Bound: device memory. At 640x480x128 f32 the first pyrDown reads 157 MB and
// writes 39 MB; the rest of the chain and the kept levels add about a third.
// Each thread computes one output pixel from global memory (the 5x5 source
// footprint of neighbouring threads overlaps, and L1/L2 absorb the reuse).
// Tiling through shared memory, or fusing the whole chain per tile so that
// the intermediate levels never reach device memory, is later work.
//
// Numerics: every intermediate is rounded exactly where the plain PyTorch
// version (ops/pyramid.py) rounds: the H pass first, then the W pass, each
// `acc = acc + x*w` in tap order; pyrUp's even phase ((a + 6b) + c) * 0.125
// and odd phase (b + c) * 0.5. The _rn intrinsics (and -fmad=false at build)
// keep nvcc from contracting a multiply-add into an FMA, so the kernels
// equal the plain version on the card bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kMaxGridZ = 65535;

__device__ __forceinline__ int reflect101(int i, int n) {
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  int m = i % period;
  if (m < 0) m += period;
  return m < n ? m : period - m;
}

// acc = (((x0*w0 + x1*w1) + x2*w2) + x3*w3) + x4*w4, [1,4,6,4,1]/16.
__device__ __forceinline__ float tap5(float x0, float x1, float x2, float x3,
                                      float x4) {
  float acc = __fmul_rn(x0, 0.0625f);
  acc = __fadd_rn(acc, __fmul_rn(x1, 0.25f));
  acc = __fadd_rn(acc, __fmul_rn(x2, 0.375f));
  acc = __fadd_rn(acc, __fmul_rn(x3, 0.25f));
  return __fadd_rn(acc, __fmul_rn(x4, 0.0625f));
}

// One pyrUp phase on source samples (prev, cur, next) for output index i.
__device__ __forceinline__ float up_phase(int i, float prev, float cur,
                                          float next) {
  if ((i & 1) == 0) {
    return __fmul_rn(__fadd_rn(__fadd_rn(prev, __fmul_rn(6.0f, cur)), next),
                     0.125f);
  }
  return __fmul_rn(__fadd_rn(cur, next), 0.5f);
}

// Source indices (prev, cur, next) of pyrUp output i over a length-n axis:
// front reflect-101 (s[-1] -> s[1]), back replicate (s[n] -> s[n-1]).
__device__ __forceinline__ void up_sources(int i, int n, int* p, int* c,
                                           int* q) {
  const int s = i >> 1;
  *c = s;
  *p = s >= 1 ? s - 1 : (n > 1 ? 1 : 0);
  *q = s + 1 < n ? s + 1 : n - 1;
}

__global__ void pyr_down_kernel(const float* __restrict__ src,
                                float* __restrict__ dst, int T, int H, int W,
                                int Ho, int Wo) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= Ho || j >= Wo) return;
  int rows[5], cols[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    rows[k] = reflect101(2 * i - 2 + k, H);
    cols[k] = reflect101(2 * j - 2 + k, W);
  }
  const long long in_plane = (long long)H * W;
  const long long out_plane = (long long)Ho * Wo;
  for (int t = blockIdx.z; t < T; t += gridDim.z) {
    const float* s = src + t * in_plane;
    float h[5];
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      const float* col = s + cols[c];
      h[c] = tap5(col[(long long)rows[0] * W], col[(long long)rows[1] * W],
                  col[(long long)rows[2] * W], col[(long long)rows[3] * W],
                  col[(long long)rows[4] * W]);
    }
    dst[t * out_plane + (long long)i * Wo + j] =
        tap5(h[0], h[1], h[2], h[3], h[4]);
  }
}

// out = g - pyrUp(gn, (h, w)); g is (T, h, w), gn is (T, hn, wn).
__global__ void lap_level_kernel(const float* __restrict__ g,
                                 const float* __restrict__ gn,
                                 float* __restrict__ out, int T, int h, int w,
                                 int hn, int wn) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= h || j >= w) return;
  int rp, rc, rq, cp, cc, cq;
  up_sources(i, hn, &rp, &rc, &rq);
  up_sources(j, wn, &cp, &cc, &cq);
  const long long plane = (long long)h * w;
  const long long plane_n = (long long)hn * wn;
  for (int t = blockIdx.z; t < T; t += gridDim.z) {
    const float* s = gn + t * plane_n;
    const float* sp = s + (long long)rp * wn;
    const float* sc = s + (long long)rc * wn;
    const float* sq = s + (long long)rq * wn;
    // H phase at the (up to) three source columns the W phase reads.
    const float up_p = up_phase(i, sp[cp], sc[cp], sq[cp]);
    const float up_c = up_phase(i, sp[cc], sc[cc], sq[cc]);
    const float up_q = up_phase(i, sp[cq], sc[cq], sq[cq]);
    const float up = up_phase(j, up_p, up_c, up_q);
    const long long o = t * plane + (long long)i * w + j;
    out[o] = __fsub_rn(g[o], up);
  }
}

dim3 grid_for(int rows, int cols, int T) {
  return dim3((cols + kBlockX - 1) / kBlockX, (rows + kBlockY - 1) / kBlockY,
              T < kMaxGridZ ? T : kMaxGridZ);
}

}  // namespace

// C interface (loaded with ctypes). Each returns the cudaError_t of its
// launch; the caller allocates every buffer and passes its current stream.
extern "C" int pyr_down_f32(const float* src, float* dst, int T, int H, int W,
                            void* stream) {
  const int Ho = (H + 1) / 2;
  const int Wo = (W + 1) / 2;
  pyr_down_kernel<<<grid_for(Ho, Wo, T), dim3(kBlockX, kBlockY), 0,
                    static_cast<cudaStream_t>(stream)>>>(src, dst, T, H, W, Ho,
                                                         Wo);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lap_level_f32(const float* g, const float* gn, float* out,
                             int T, int h, int w, int hn, int wn,
                             void* stream) {
  lap_level_kernel<<<grid_for(h, w, T), dim3(kBlockX, kBlockY), 0,
                     static_cast<cudaStream_t>(stream)>>>(g, gn, out, T, h, w,
                                                          hn, wn);
  return static_cast<int>(cudaGetLastError());
}
