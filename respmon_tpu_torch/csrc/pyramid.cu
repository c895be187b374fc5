// Pyramid kernels of the EVM calibration, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of respmon_tpu/ops/pyramid_pallas.py:
//   - laplacian_band_levels (K1, :295-321, body _make_kernel :90-99): the
//     whole Gaussian chain of a frame kept in VMEM, only the kept Laplacian
//     levels written out;
//   - gauss_level_tiled (K2, :245-291, strip kernel :269-273): a Gaussian
//     level of frames too large for VMEM, over halo'd W-strips.
// Here both are two kernels, composed by the plan of ops/pyramid_cuda.py:
//   pyr_down_levels_f32 (A): one or two pyrDowns fused per output tile;
//   pyr_tail_f32 (B): from a level whose remaining pyramid fits one block's
//     shared memory (the plan's budget), every further level of a frame and
//     the kept Laplacian levels, one block per frame;
//   lap_level_f32: one kept level g - pyrUp(gn) from two levels in device
//     memory, for the kept levels above B's (a route chosen by the shapes:
//     no default configuration takes it).
// At 640x480 L9/S4 the chain is one A (d = 2) and one B: two launches; at
// 1080p A (d = 2), A (d = 1) and B.
//
// Bound: device memory. At (128, 480, 640) A reads 157 MB and writes the
// 10 MB of level 2; every other byte of the chain (B's 10 MB in, 0.8 MB of
// kept levels out) is small beside it. The design keeps every level that
// is not an output on the chip:
// - A's block owns one tile of level d and walks frames t, t + gridDim.z,
//   ...: it stages the frame's clamped level-0 window in shared memory by
//   cp.async (16-byte copies where the width and pointer allow them, else
//   4-byte ones), the next frame's window in flight while the current one
//   is computed. Each level is an H pass into a scratch buffer, then a W
//   pass back into the stage buffer, whose level below is spent by then;
//   level d goes out to device memory row by row. A level-d tile of n rows
//   reads 2^d (n + 3) - 3 rows of level 0: the halo is read again by the
//   neighbouring tile, mostly from L2.
// - B reads its frame's level once by cp.async, computes each further level
//   from five column sums read out of shared memory (no scratch), and
//   writes each kept g[l] - pyrUp(g[l+1]) straight to device memory.
// What holds A back on the H100 is not the bytes but issuing the arithmetic
// (nine rounded operations an output of each pass, in the plain version's
// order) with its loads and index work: the passes give each thread runs
// of outputs whose chains of dependent adds interleave (down_level). A
// third fused level costs more in recomputed halo, and in passes too small
// to fill a block, than it saves in bytes, so A fuses at most two.
// Measured times beside the bounds: PERF.md.
//
// Borders: reflect-101 at every level (periodic for n = 1, 2). A tile's
// windows are the rows and columns its outputs need, level by level,
// clamped to the level; every reflected index lies inside them, so a read
// of level l at index i is a read of reflect101(i, n_l) in the window.
// pyrUp reflects at the front and replicates at the back.
//
// Numerics: every intermediate is rounded exactly where the plain PyTorch
// version (ops/pyramid.py) rounds: the H pass first, then the W pass, each
// `acc = acc + x*w` in tap order; pyrUp's even phase ((a + 6b) + c) * 0.125
// and odd phase (b + c) * 0.5, then the subtraction. The _rn intrinsics
// (and -fmad=false at build) keep nvcc from contracting a multiply-add into
// an FMA, so the kernels equal the plain version on the card bit for bit.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kThreads = kBlockX * kBlockY;
constexpr int kMaxGridZ = 65535;
constexpr int kMaxDevices = 64;
constexpr int kTailThreads = 1024;
constexpr int kRun = 4;  // outputs a thread of A computes along a row or column

__device__ __forceinline__ int reflect101(int i, int n) {
  if (i >= 0 && i < n) return i;
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

// pyrDown output (i, j) of the (h, w) level at src: five column sums over
// the H taps, then the W taps.
__device__ __forceinline__ float down_at(const float* src, int h, int w,
                                         int i, int j) {
  int rows[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) rows[k] = reflect101(2 * i - 2 + k, h) * w;
  float s[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const float* col = src + reflect101(2 * j - 2 + k, w);
    s[k] = tap5(col[rows[0]], col[rows[1]], col[rows[2]], col[rows[3]],
                col[rows[4]]);
  }
  return tap5(s[0], s[1], s[2], s[3], s[4]);
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

// g(i, j) - pyrUp(gn)(i, j) for a level g of width w and the (hn, wn)
// level gn above it, both frames in one plane.
__device__ __forceinline__ float lap_at(const float* g, int w, const float* gn,
                                        int hn, int wn, int i, int j) {
  int rp, rc, rq, cp, cc, cq;
  up_sources(i, hn, &rp, &rc, &rq);
  up_sources(j, wn, &cp, &cc, &cq);
  const float* sp = gn + rp * wn;
  const float* sc = gn + rc * wn;
  const float* sq = gn + rq * wn;
  // H phase at the (up to) three source columns the W phase reads.
  const float up_p = up_phase(i, sp[cp], sc[cp], sq[cp]);
  const float up_c = up_phase(i, sp[cc], sc[cc], sq[cc]);
  const float up_q = up_phase(i, sp[cq], sc[cq], sq[cq]);
  return __fsub_rn(g[i * w + j], up_phase(j, up_p, up_c, up_q));
}

// Asynchronous copies global -> shared of 16 or 4 bytes.
__device__ __forceinline__ void copy16(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
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

// ---------------------------------------------------------------------------
// A: d fused pyrDowns per output tile.

// The tile of level D that one block owns, rows x cols.
template <int D>
struct Tile;
template <>
struct Tile<1> {
  static constexpr int rows = 32, cols = 64;
};
template <>
struct Tile<2> {
  static constexpr int rows = 16, cols = 32;
};

// Extent, k levels down, of the window that n outputs need: n -> 2n + 3.
__host__ __device__ constexpr int window(int n, int k) {
  return k == 0 ? n : 2 * window(n, k - 1) + 3;
}

// Row strides of A's buffers in floats are fixed at compile time, so that
// every shared-memory access of a pass has an immediate offset. Level 0 is
// staged in rows of whole 16-byte units (up to 3 columns more at each end
// than the tile needs); every other buffer has an odd stride, so that lanes
// on neighbouring rows fall on distinct banks. level_stride(l) is the
// stride of level l >= 1 in the stage buffer, and of the H pass's output
// from level l in scratch.
template <int D>
__host__ __device__ constexpr int level_stride(int l) {
  return window(Tile<D>::cols, D - l) | 1;
}

template <int D>
struct Footprint {
  static constexpr int stage_stride =
      (window(Tile<D>::cols, D) + 6 + 3) / 4 * 4;
  static constexpr int stage = window(Tile<D>::rows, D) * stage_stride;
  static constexpr int scratch =
      window(Tile<D>::rows, D - 1) * level_stride<D>(0);
  static constexpr int bytes = (2 * stage + scratch) * sizeof(float);
};

// Items [0, rows * cols) of a pass, cols fastest, dealt out kThreads apart:
// the thread's next (row, col) without a division per item.
struct Walk {
  int row, col, step_rows, step_cols, cols;
  __device__ Walk(int tid, int cols_) : cols(cols_) {
    row = tid / cols;
    col = tid - row * cols;
    step_rows = kThreads / cols;
    step_cols = kThreads - step_rows * cols;
  }
  __device__ void next() {
    row += step_rows;
    col += step_cols;
    if (col >= cols) {
      col -= cols;
      ++row;
    }
  }
};

// x[q] = src[(reflect101(first + q, n_level) - lo) * kStep] for q < 2n + 3:
// the taps of n outputs of a run, all read before any is summed.
template <int kStep>
__device__ __forceinline__ void taps(float (&x)[2 * kRun + 3],
                                     const float* src, int first, int n,
                                     int n_level, int lo) {
  if (first >= 0 && first + 2 * n + 2 < n_level) {
    const float* p = src + (first - lo) * kStep;
#pragma unroll
    for (int q = 0; q < 2 * kRun + 3; ++q)
      if (q < 2 * n + 3) x[q] = p[q * kStep];
  } else {
#pragma unroll
    for (int q = 0; q < 2 * kRun + 3; ++q)
      if (q < 2 * n + 3)
        x[q] = src[(reflect101(first + q, n_level) - lo) * kStep];
  }
}

// Output k of a run from its taps.
__device__ __forceinline__ float run_out(const float (&x)[2 * kRun + 3],
                                         int k) {
  return tap5(x[2 * k], x[2 * k + 1], x[2 * k + 2], x[2 * k + 3],
              x[2 * k + 4]);
}

// One level of A: level l of the window (in stage, row stride kIn, column
// c_lo at `col0` of a row) to level l+1 (in stage again, row stride kOut:
// level l is spent by then). The H pass gives a thread runs of kRun
// outputs down one column (lanes on neighbouring columns), the W pass runs
// along one row (lanes on neighbouring rows). A run's taps are all read
// before any sum, and its kRun sums are computed whether or not they are
// stored, so that their chains of dependent adds interleave.
template <int kIn, int kMid, int kOut>
__device__ __forceinline__ void down_level(float* stage, float* scratch,
                                           int tid, int col0, int h, int w,
                                           int r_lo, int c_lo, int c_hi,
                                           int r_lo_n, int r_hi_n, int c_lo_n,
                                           int c_hi_n) {
  const int n_rows = r_hi_n - r_lo_n + 1;
  const int n_cols = c_hi - c_lo + 1;
  const int h_runs = (n_rows + kRun - 1) / kRun;
  for (Walk it(tid, n_cols); it.row < h_runs; it.next()) {
    const int i0 = it.row * kRun, n = min(kRun, n_rows - i0);
    float x[2 * kRun + 3] = {};
    taps<kIn>(x, stage + col0 + it.col, 2 * (r_lo_n + i0) - 2, n, h, r_lo);
    float v[kRun];
#pragma unroll
    for (int k = 0; k < kRun; ++k) v[k] = run_out(x, k);
    float* out = scratch + i0 * kMid + it.col;
#pragma unroll
    for (int k = 0; k < kRun; ++k)
      if (k < n) out[k * kMid] = v[k];
  }
  __syncthreads();
  const int n_out = c_hi_n - c_lo_n + 1;
  const int w_runs = (n_out + kRun - 1) / kRun;
  for (Walk it(tid, n_rows); it.row < w_runs; it.next()) {
    const int i = it.col, j0 = it.row * kRun, n = min(kRun, n_out - j0);
    float x[2 * kRun + 3] = {};
    taps<1>(x, scratch + i * kMid, 2 * (c_lo_n + j0) - 2, n, w, c_lo);
    float v[kRun];
#pragma unroll
    for (int k = 0; k < kRun; ++k) v[k] = run_out(x, k);
    float* out = stage + i * kOut + j0;
#pragma unroll
    for (int k = 0; k < kRun; ++k)
      if (k < n) out[k] = v[k];
  }
  __syncthreads();
}

template <int D>
__global__ void __launch_bounds__(kThreads)
pyr_down_levels_kernel(const float* __restrict__ src, float* __restrict__ dst,
                       int T, int H, int W, bool wide) {
  using F = Footprint<D>;
  extern __shared__ __align__(16) float smem[];
  float* const scratch = smem + 2 * F::stage;
  const int tid = threadIdx.x;

  // Level sizes, and per level the rows [r_lo, r_hi] and columns
  // [c_lo, c_hi] (inclusive, clamped to the level) that the tile needs.
  int h[D + 1], w[D + 1], r_lo[D + 1], r_hi[D + 1], c_lo[D + 1], c_hi[D + 1];
  h[0] = H;
  w[0] = W;
#pragma unroll
  for (int l = 0; l < D; ++l) {
    h[l + 1] = (h[l] + 1) / 2;
    w[l + 1] = (w[l] + 1) / 2;
  }
  r_lo[D] = blockIdx.y * Tile<D>::rows;
  r_hi[D] = min(r_lo[D] + Tile<D>::rows, h[D]) - 1;
  c_lo[D] = blockIdx.x * Tile<D>::cols;
  c_hi[D] = min(c_lo[D] + Tile<D>::cols, w[D]) - 1;
#pragma unroll
  for (int l = D - 1; l >= 0; --l) {
    r_lo[l] = max(2 * r_lo[l + 1] - 2, 0);
    r_hi[l] = min(2 * r_hi[l + 1] + 2, h[l] - 1);
    c_lo[l] = max(2 * c_lo[l + 1] - 2, 0);
    c_hi[l] = min(2 * c_hi[l + 1] + 2, w[l] - 1);
  }
  // The staged columns [c0, c1): for 16-byte copies widened to multiples
  // of 4 (W is one then).
  const int c0 = wide ? c_lo[0] & ~3 : c_lo[0];
  const int c1 = wide ? min((c_hi[0] + 4) & ~3, W) : c_hi[0] + 1;
  const int rows0 = r_hi[0] - r_lo[0] + 1;
  const long long in_plane = (long long)H * W;
  const long long out_plane = (long long)h[D] * w[D];

  auto fill = [&](float* stage, int t) {
    const float* f = src + t * in_plane + (long long)r_lo[0] * W + c0;
    if (wide) {
      for (Walk it(tid, (c1 - c0) / 4); it.row < rows0; it.next())
        copy16(stage + it.row * F::stage_stride + 4 * it.col,
               f + (long long)it.row * W + 4 * it.col);
    } else {
      for (Walk it(tid, c1 - c0); it.row < rows0; it.next())
        copy4(stage + it.row * F::stage_stride + it.col,
              f + (long long)it.row * W + it.col);
    }
  };

  // Levels 1..D of frame t from its level-0 window in stage, level D out
  // to device memory row by row.
  auto levels = [&](float* stage, int t) {
    down_level<F::stage_stride, level_stride<D>(0), level_stride<D>(1)>(
        stage, scratch, tid, c_lo[0] - c0, h[0], w[0], r_lo[0], c_lo[0],
        c_hi[0], r_lo[1], r_hi[1], c_lo[1], c_hi[1]);
    if constexpr (D >= 2)
      down_level<level_stride<D>(1), level_stride<D>(1), level_stride<D>(2)>(
          stage, scratch, tid, 0, h[1], w[1], r_lo[1], c_lo[1], c_hi[1],
          r_lo[2], r_hi[2], c_lo[2], c_hi[2]);
    float* const out =
        dst + t * out_plane + (long long)r_lo[D] * w[D] + c_lo[D];
    for (Walk it(tid, c_hi[D] - c_lo[D] + 1); it.row <= r_hi[D] - r_lo[D];
         it.next())
      out[(long long)it.row * w[D] + it.col] =
          stage[it.row * level_stride<D>(D) + it.col];
    __syncthreads();
  };

  // Two stage buffers: frame t is computed while the block's next frame
  // lands. Every step commits a group, empty or not, so that "all but the
  // newest group landed" means "frame t landed". The buffer is addressed
  // from smem, not picked from an array of pointers, so that the compiler
  // keeps its accesses shared-memory ones.
  int t = blockIdx.z;
  if (t < T) fill(smem, t);
  commit();
  for (int k = 0; t < T; ++k, t += gridDim.z) {
    const int next = t + gridDim.z;
    if (next < T) fill(smem + ((k + 1) & 1) * F::stage, next);
    commit();
    wait_but<1>();
    __syncthreads();
    levels(smem + (k & 1) * F::stage, t);  // ends in a barrier
  }
  wait_but<0>();
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Blocks of A (d = D) that fit the card at once, with the shared memory it
// asks for allowed; both once per device.
template <int D>
cudaError_t resident_blocks(int* blocks) {
  static int cache[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && cache[device] > 0) {
    *blocks = cache[device];
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(pyr_down_levels_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Footprint<D>::bytes);
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, pyr_down_levels_kernel<D>, kThreads, Footprint<D>::bytes);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  *blocks = (per_sm > 0 ? per_sm : 1) * sms;
  if (device < kMaxDevices) cache[device] = *blocks;
  return cudaSuccess;
}

template <int D>
int launch_down(const float* src, float* dst, int T, int H, int W,
                void* stream) {
  int blocks = 0;
  cudaError_t err = resident_blocks<D>(&blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  int h = H, w = W;
  for (int l = 0; l < D; ++l) {
    h = (h + 1) / 2;
    w = (w + 1) / 2;
  }
  const int tiles_x = (w + Tile<D>::cols - 1) / Tile<D>::cols;
  const int tiles_y = (h + Tile<D>::rows - 1) / Tile<D>::rows;
  // As many frame groups as keep every block resident at once; each block
  // walks its tile through T / groups frames.
  long long groups = blocks / ((long long)tiles_x * tiles_y);
  if (groups < 1) groups = 1;
  if (groups > T) groups = T;
  if (groups > kMaxGridZ) groups = kMaxGridZ;
  const bool wide = W % 4 == 0 && aligned(src, 16);
  pyr_down_levels_kernel<D>
      <<<dim3(tiles_x, tiles_y, static_cast<int>(groups)),
         kThreads, Footprint<D>::bytes,
         static_cast<cudaStream_t>(stream)>>>(src, dst, T, H, W, wide);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// B: the tail of the pyramid, one block per frame, all in shared memory.

// Block t takes frame t. The kept levels go to `out` one after another,
// each a (T, h_l, w_l) block.
__global__ void __launch_bounds__(kTailThreads)
pyr_tail_kernel(const float* __restrict__ src, float* __restrict__ out, int T,
                int H, int W, int n_levels, int first_kept, bool wide) {
  // Levels 0..n_levels-1 of the frame, packed one after the other.
  extern __shared__ __align__(16) float pyr[];
  const int tid = threadIdx.x;
  const int t = blockIdx.x;
  const int plane = H * W;
  const float* f = src + (long long)t * plane;
  if (wide) {
    for (int e = 4 * tid; e < plane; e += 4 * kTailThreads)
      copy16(pyr + e, f + e);
  } else {
    for (int e = tid; e < plane; e += kTailThreads) copy4(pyr + e, f + e);
  }
  commit();
  wait_but<0>();
  __syncthreads();

  int h = H, w = W, off = 0;
  for (int l = 1; l < n_levels; ++l) {
    const int hn = (h + 1) / 2, wn = (w + 1) / 2, off_n = off + h * w;
    for (int e = tid; e < hn * wn; e += kTailThreads) {
      const int i = e / wn, j = e - i * wn;
      pyr[off_n + e] = down_at(pyr + off, h, w, i, j);
    }
    __syncthreads();
    h = hn;
    w = wn;
    off = off_n;
  }

  h = H;
  w = W;
  off = 0;
  long long kept = 0;  // where level l's (T, h, w) block starts in out
  for (int l = 0; l + 1 < n_levels; ++l) {
    const int hn = (h + 1) / 2, wn = (w + 1) / 2, off_n = off + h * w;
    if (l >= first_kept) {
      float* o = out + kept + (long long)t * h * w;
      for (int e = tid; e < h * w; e += kTailThreads) {
        const int i = e / w, j = e - i * w;
        o[e] = lap_at(pyr + off, w, pyr + off_n, hn, wn, i, j);
      }
      kept += (long long)T * h * w;
    }
    h = hn;
    w = wn;
    off = off_n;
  }
}

// ---------------------------------------------------------------------------
// lap_level_f32: out = g - pyrUp(gn, (h, w)); g is (T, h, w), gn (T, hn, wn).

__global__ void lap_level_kernel(const float* __restrict__ g,
                                 const float* __restrict__ gn,
                                 float* __restrict__ out, int T, int h, int w,
                                 int hn, int wn) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= h || j >= w) return;
  const long long plane = (long long)h * w;
  const long long plane_n = (long long)hn * wn;
  for (int t = blockIdx.z; t < T; t += gridDim.z) {
    out[t * plane + (long long)i * w + j] =
        lap_at(g + t * plane, w, gn + t * plane_n, hn, wn, i, j);
  }
}

}  // namespace

// C interface (loaded with ctypes). Each returns the cudaError_t of its
// launch; the caller allocates every buffer and passes its current stream.

// dst = pyrDown applied d times (1 <= d <= 2) to the (T, H, W) video src.
extern "C" int pyr_down_levels_f32(const float* src, float* dst, int T, int H,
                                   int W, int d, void* stream) {
  switch (d) {
    case 1:
      return launch_down<1>(src, dst, T, H, W, stream);
    case 2:
      return launch_down<2>(src, dst, T, H, W, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The Laplacian levels [first_kept, n_levels - 2] of the n_levels-level
// pyramid whose level 0 is the (T, H, W) video src, into out: level l's
// (T, h_l, w_l) block after those of the kept levels before it. The whole
// pyramid of a frame must fit a block's shared memory; the launch fails
// where it does not.
extern "C" int pyr_tail_f32(const float* src, float* out, int T, int H,
                            int W, int n_levels, int first_kept,
                            void* stream) {
  if (n_levels < 2 || first_kept < 0 || first_kept > n_levels - 2)
    return static_cast<int>(cudaErrorInvalidValue);
  long long floats = 0;
  for (int l = 0, h = H, w = W; l < n_levels;
       ++l, h = (h + 1) / 2, w = (w + 1) / 2)
    floats += (long long)h * w;
  if (floats * sizeof(float) > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = static_cast<int>(floats * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      pyr_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool wide = (long long)H * W % 4 == 0 && aligned(src, 16);
  pyr_tail_kernel<<<T, kTailThreads, bytes,
                    static_cast<cudaStream_t>(stream)>>>(
      src, out, T, H, W, n_levels, first_kept, wide);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lap_level_f32(const float* g, const float* gn, float* out,
                             int T, int h, int w, int hn, int wn,
                             void* stream) {
  const dim3 grid((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY,
                  T < kMaxGridZ ? T : kMaxGridZ);
  lap_level_kernel<<<grid, dim3(kBlockX, kBlockY), 0,
                     static_cast<cudaStream_t>(stream)>>>(g, gn, out, T, h, w,
                                                          hn, wn);
  return static_cast<int>(cudaGetLastError());
}
