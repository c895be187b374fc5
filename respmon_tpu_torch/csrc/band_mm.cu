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
// The products are computed here, on the tensor cores, not by a library.
//
// Bound: the bytes that must move (every operand read once, the output
// written once). The matrices have at most 5 nonzeros a row, so the
// operations the data needs are few; what the design has to do is keep the
// arithmetic and the re-reads out of the way of the one pass over the video.
// Measured times, beside the bound and torch.matmul's: PERF.md.
//
// Design.
// - Only the band is walked. A block owns one output tile of one frame: 64
//   rows of A by 128 columns (left) or 128 rows by 64 columns of A (right),
//   so the side along which A is banded is kBandTile wide, and the block
//   reads its own [k_lo, k_hi) from the ranges the host computed from A's
//   values (ops/pyramid_mm.slab_ranges). A dense A gives the full range and
//   the dense product, an all-zero tile an empty range and zeros.
// - The range is walked in slabs of 32 through a ring of three shared-memory
//   buffers (80 KB a block, two blocks an SM) that cp.async fills (16 bytes
//   a thread, or 4 bytes where a width or a pointer does not allow 16: half
//   of a pyramid's levels), so the next two slabs load while one is
//   multiplied. Copies outside the operands or the range fill with zeros,
//   stores are masked.
// - The arithmetic is TF32 mma.sync (m16n8k8, f32 accumulators) at float32
//   accuracy: the video operand is split in registers into hi = tf32(x) and
//   lo = tf32(x - hi) and multiplied twice (hi + lo is x to 2^-21 |x|). A
//   needs no split when the host found every entry exact in TF32, as the
//   pyramid's are (sums of 1/16, 4/16, 6/16 or 1/8, 6/8, 1/2); any other A
//   is split too (hi*hi + hi*lo + lo*hi). The padded rows of the two slabs
//   make every fragment read free of bank conflicts.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBandTile = 64;  // tile extent along A's banded side
constexpr int kSlab = 32;      // inner-dimension slab
constexpr int kStages = 3;     // slabs in the ring
constexpr int kThreads = 256;
constexpr int kXPad = 4;       // row paddings of the two slabs in shared memory
constexpr int kYPad = 8;
constexpr int kMaxGridZ = 65535;
constexpr int kMaxDevices = 64;

// Asynchronous copies global -> shared of 16 or 4 bytes; with take == false
// nothing is read and the destination is filled with zeros.
__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       bool take) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int bytes = take ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void copy4(float* dst, const float* src, bool take) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int bytes = take ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kPending of this thread's copy groups are in flight.
template <int kPending>
__device__ __forceinline__ void wait_but() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// x as two TF32 numbers (float32 bit patterns whose low 13 bits are zero):
// hi is x rounded to nearest, ties away from zero (half a TF32 ulp added to
// the magnitude, the low bits cleared: what cvt.rna.tf32.f32 gives, in
// integer instructions, which the card runs faster than conversions); lo
// is the rest x - hi, which float32 holds exactly, rounded the same way.
template <bool kSplit>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (kSplit) {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
  } else {
    hi = __float_as_uint(x);  // exact in TF32: the low bits are zero
    lo = 0;
  }
}

// c += a * b for a 16x8 (row-major) and an 8x8 (column-major) TF32 fragment.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// C[t] = X[t] * Y[t] (or M[t] - X[t] * Y[t]); X is (m,k), Y is (k,n), all
// row-major. A stride of 0 shares one matrix between all frames: X in the
// left product (kLeft), Y in the right one; kExact says that it is exact in
// TF32. x_wide / y_wide say that the operand's rows and base allow 16-byte
// copies, c_wide that the output's (and the minuend's) allow 8-byte accesses.
template <bool kLeft, bool kExact>
__global__ void __launch_bounds__(kThreads, 2)
band_product_kernel(const float* __restrict__ X, long long stride_x,
                    const float* __restrict__ Y, long long stride_y,
                    const float* __restrict__ minuend, float* __restrict__ C,
                    const int2* __restrict__ ranges, int T, int m, int k,
                    int n, bool x_wide, bool y_wide, bool c_wide) {
  constexpr int BM = kLeft ? kBandTile : 2 * kBandTile;
  constexpr int BN = kLeft ? 2 * kBandTile : kBandTile;
  constexpr bool kSplitX = !kLeft || !kExact;  // the video is always split
  constexpr bool kSplitY = kLeft || !kExact;
  constexpr int kWarpsN = BN / 32;  // a warp owns 32 x 32 outputs
  constexpr int XW = kSlab + kXPad;
  constexpr int YW = BN + kYPad;

  // The ring: kStages slabs of X, then kStages slabs of Y.
  extern __shared__ __align__(16) float ring[];
  float(*xs)[BM][XW] = reinterpret_cast<float(*)[BM][XW]>(ring);
  float(*ys)[kSlab][YW] =
      reinterpret_cast<float(*)[kSlab][YW]>(ring + kStages * BM * XW);

  const int tid = threadIdx.x;
  const int gid = (tid % 32) / 4;  // the lane's place in an MMA fragment
  const int tig = tid % 4;
  const int wr = (tid / 32) / kWarpsN * 32;  // the warp's corner in the tile
  const int wc = (tid / 32) % kWarpsN * 32;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const long long plane = (long long)m * n;

  // The slabs outside this tile's range hold only zeros of the shared
  // matrix: they are not walked.
  int k_lo = 0, k_hi = k;
  if (ranges != nullptr) {
    const int2 r = ranges[kLeft ? blockIdx.y : blockIdx.x];
    k_lo = r.x;
    k_hi = r.y;
  }
  const int n_slabs = (k_hi - k_lo + kSlab - 1) / kSlab;

  for (int t = blockIdx.z; t < T; t += gridDim.z) {
    const float* x = X + t * stride_x;
    const float* y = Y + t * stride_y;

    // Start the copies of the slab at k0 into a ring buffer.
    auto fill = [&](int stage, int k0) {
      if (x_wide) {
        for (int e = tid; e < BM * (kSlab / 4); e += kThreads) {
          const int r = e / (kSlab / 4), c = (e % (kSlab / 4)) * 4;
          const int gr = row0 + r, gc = k0 + c;
          const bool take = gr < m && gc < k_hi;
          copy16(&xs[stage][r][c], take ? x + (long long)gr * k + gc : x, take);
        }
      } else {
        for (int e = tid; e < BM * kSlab; e += kThreads) {
          const int r = e / kSlab, c = e % kSlab;
          const int gr = row0 + r, gc = k0 + c;
          const bool take = gr < m && gc < k_hi;
          copy4(&xs[stage][r][c], take ? x + (long long)gr * k + gc : x, take);
        }
      }
      if (y_wide) {
        for (int e = tid; e < kSlab * (BN / 4); e += kThreads) {
          const int r = e / (BN / 4), c = (e % (BN / 4)) * 4;
          const int gr = k0 + r, gc = col0 + c;
          const bool take = gr < k_hi && gc < n;
          copy16(&ys[stage][r][c], take ? y + (long long)gr * n + gc : y, take);
        }
      } else {
        for (int e = tid; e < kSlab * BN; e += kThreads) {
          const int r = e / BN, c = e % BN;
          const int gr = k0 + r, gc = col0 + c;
          const bool take = gr < k_hi && gc < n;
          copy4(&ys[stage][r][c], take ? y + (long long)gr * n + gc : y, take);
        }
      }
    };

    // acc[i][j] is the 16x8 fragment at rows wr + 16 i, columns wc + 8 j.
    float acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;

    auto multiply = [&](int stage) {
#pragma unroll
      for (int kk = 0; kk < kSlab; kk += 8) {
        uint32_t xh[2][4], xl[2][4], yh[4][2], yl[4][2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float* p = &xs[stage][wr + i * 16 + gid][kk + tig];
          split<kSplitX>(p[0], xh[i][0], xl[i][0]);
          split<kSplitX>(p[8 * XW], xh[i][1], xl[i][1]);
          split<kSplitX>(p[4], xh[i][2], xl[i][2]);
          split<kSplitX>(p[8 * XW + 4], xh[i][3], xl[i][3]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* p = &ys[stage][kk + tig][wc + j * 8 + gid];
          split<kSplitY>(p[0], yh[j][0], yl[j][0]);
          split<kSplitY>(p[4 * YW], yh[j][1], yl[j][1]);
        }
        // The small terms first.
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if constexpr (kSplitX) mma_tf32(acc[i][j], xl[i], yh[j]);
            if constexpr (kSplitY) mma_tf32(acc[i][j], xh[i], yl[j]);
            mma_tf32(acc[i][j], xh[i], yh[j]);
          }
      }
    };

    // Every step commits a group, empty or not, so that the count of groups
    // in flight tells which slab has landed, whatever the range's length.
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n_slabs) fill(s, k_lo + s * kSlab);
      commit();
    }
    for (int i = 0; i < n_slabs; ++i) {
      wait_but<kStages - 2>();  // slab i has landed (this thread's copies)
      __syncthreads();          // ... and everyone's; slab i-1 is read out
      const int ahead = i + kStages - 1;
      if (ahead < n_slabs) fill(ahead % kStages, k_lo + ahead * kSlab);
      commit();
      multiply(i % kStages);
    }
    wait_but<0>();

    const float* sub = minuend != nullptr ? minuend + t * plane : nullptr;
    float* c = C + t * plane;
    // A fragment holds, per lane, two neighbouring columns of rows gid and
    // gid + 8.
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = row0 + wr + i * 16 + half * 8 + gid;
        if (r >= m) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = col0 + wc + j * 8 + 2 * tig;
          const long long o = (long long)r * n + col;
          float v0 = acc[i][j][2 * half], v1 = acc[i][j][2 * half + 1];
          if (c_wide && col < n) {
            if (sub != nullptr) {
              const float2 s = *reinterpret_cast<const float2*>(sub + o);
              v0 = s.x - v0, v1 = s.y - v1;
            }
            *reinterpret_cast<float2*>(c + o) = make_float2(v0, v1);
          } else {
            if (col < n) c[o] = sub != nullptr ? sub[o] - v0 : v0;
            if (col + 1 < n) c[o + 1] = sub != nullptr ? sub[o + 1] - v1 : v1;
          }
        }
      }
    // The next frame's first copies overwrite buffers that a slower warp
    // may still be reading.
    __syncthreads();
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <bool kLeft, bool kExact>
int launch(const float* X, long long stride_x, const float* Y,
           long long stride_y, const float* minuend, float* C,
           const int* ranges, int n_ranges, int T, int m, int k, int n,
           void* stream) {
  constexpr int BM = kLeft ? kBandTile : 2 * kBandTile;
  constexpr int BN = kLeft ? 2 * kBandTile : kBandTile;
  if (ranges != nullptr &&
      n_ranges != ((kLeft ? m : n) + kBandTile - 1) / kBandTile)
    return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte accesses need rows (and with them frames) that start on 16
  // bytes; the half of the pyramid's levels that do not have them take the
  // 4-byte copies.
  const bool x_wide = k % 4 == 0 && aligned(X, 16);
  const bool y_wide = n % 4 == 0 && aligned(Y, 16);
  const bool c_wide = n % 2 == 0 && aligned(C, 8) &&
                      (minuend == nullptr || aligned(minuend, 8));
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM,
                  T < kMaxGridZ ? T : kMaxGridZ);
  // The ring is more than the 48 KB a kernel gets without asking: ask, once
  // per device.
  constexpr int kRingBytes =
      kStages * (BM * (kSlab + kXPad) + kSlab * (BN + kYPad)) * sizeof(float);
  static bool allowed[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices || !allowed[device]) {
    err = cudaFuncSetAttribute(band_product_kernel<kLeft, kExact>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kRingBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < kMaxDevices) allowed[device] = true;
  }
  band_product_kernel<kLeft, kExact>
      <<<grid, kThreads, kRingBytes, static_cast<cudaStream_t>(stream)>>>(
          X, stride_x, Y, stride_y, minuend, C,
          reinterpret_cast<const int2*>(ranges), T, m, k, n, x_wide, y_wide,
          c_wide);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface (loaded with ctypes). Each returns the cudaError_t of its
// launch; the caller allocates every buffer and passes its current stream.
// ranges is null (walk the whole inner dimension) or holds n_ranges pairs
// [k_lo, k_hi), one per kBandTile rows (left) or columns (right) of A,
// multiples of 8 or equal to k, outside which that tile of A is all zero.
// a_exact != 0 says that every entry of A is exact in TF32 (its low 13
// significand bits are zero); A is then not split.

// C[t] = A * B[t]: A is (m,k), B is (T,k,n), C is (T,m,n).
extern "C" int band_left_f32(const float* A, const float* B, float* C, int T,
                             int m, int k, int n, const int* ranges,
                             int n_ranges, int a_exact, void* stream) {
  const long long frame = (long long)k * n;
  return a_exact ? launch<true, true>(A, 0, B, frame, nullptr, C, ranges,
                                      n_ranges, T, m, k, n, stream)
                 : launch<true, false>(A, 0, B, frame, nullptr, C, ranges,
                                       n_ranges, T, m, k, n, stream);
}

// C[t] = B[t] * A, or minuend[t] - B[t] * A when minuend is not null:
// B is (T,m,k), A is (k,n), minuend and C are (T,m,n).
extern "C" int band_right_f32(const float* B, const float* A,
                              const float* minuend, float* C, int T, int m,
                              int k, int n, const int* ranges, int n_ranges,
                              int a_exact, void* stream) {
  const long long frame = (long long)m * k;
  return a_exact ? launch<false, true>(B, frame, A, 0, minuend, C, ranges,
                                       n_ranges, T, m, k, n, stream)
                 : launch<false, false>(B, frame, A, 0, minuend, C, ranges,
                                        n_ranges, T, m, k, n, stream);
}
