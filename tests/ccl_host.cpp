// Runs csrc/ccl.cu's kernels on the host, for tests/test_torch_ccl.py: the
// test writes the .cu's text before its launcher into ccl_kernels.inc, and
// this file gives it host stand-ins for the CUDA built-ins. Each block runs
// in turn, in a shuffled order, with one thread (so __syncthreads is
// nothing and an atomic is a plain update); the kernels that walk the batch
// with a grid stride get `grid` blocks.
#include <algorithm>
#include <climits>
#include <cmath>
#include <cstddef>
#include <random>
#include <vector>

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
static dim3 blockIdx(0, 0, 0), threadIdx(0, 0, 0), blockDim(1, 1, 1),
    gridDim(1, 1, 1);
#define __global__
#define __device__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(...)
using std::max;
using std::min;
static int atomicMin(int* p, int v) {
  const int o = *p;
  if (v < o) *p = v;
  return o;
}
static int atomicMax(int* p, int v) {
  const int o = *p;
  if (v > o) *p = v;
  return o;
}
static int atomicAdd(int* p, int v) { const int o = *p; *p += v; return o; }
static int __ldcg(const int* p) { return *p; }
static int __ldg(const int* p) { return *p; }
static void __stcg(int* p, int v) { *p = v; }
template <class T> static T __shfl_down_sync(unsigned, T v, int) { return v; }
static void __syncthreads() {}

#include "ccl_kernels.inc"

// ccl_largest_bbox's six steps, in its order and with its buffers.
extern "C" void host_ccl(const unsigned char* fg, int masks, int h, int w,
                         int* work, int* xywh, unsigned char* found,
                         float* area, int grid, unsigned seed) {
  const size_t n = static_cast<size_t>(masks) * h * w;
  int* par = work;
  int* lab = par + n;
  int* stats = lab + n;
  int* roots = stats + kStats * n;
  int* roots_count = roots + n;
  std::mt19937 rng(seed);
  const dim3 tiles((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, masks);
  std::vector<dim3> tile_blocks;
  for (unsigned z = 0; z < tiles.z; ++z)
    for (unsigned y = 0; y < tiles.y; ++y)
      for (unsigned x = 0; x < tiles.x; ++x) tile_blocks.emplace_back(x, y, z);
  std::vector<unsigned> grid_blocks(grid);
  for (int i = 0; i < grid; ++i) grid_blocks[i] = i;
  auto over_tiles = [&](auto kernel) {
    std::shuffle(tile_blocks.begin(), tile_blocks.end(), rng);
    gridDim = tiles;
    for (const dim3& b : tile_blocks) { blockIdx = b; kernel(); }
  };
  auto over_grid = [&](auto kernel) {
    std::shuffle(grid_blocks.begin(), grid_blocks.end(), rng);
    gridDim = dim3(grid);
    for (unsigned b : grid_blocks) { blockIdx = dim3(b); kernel(); }
  };
  const size_t runs = static_cast<size_t>(masks) * h * ((w + kRun - 1) / kRun);
  over_tiles([&] { holes_tiles(fg, par, roots_count, h, w); });
  over_grid([&] { holes_merge(fg, par, h, w, n); });
  over_tiles([&] { label_tiles(fg, par, lab, stats, h, w); });
  over_grid([&] { label_merge(lab, h, w, n); });
  over_grid([&] { accumulate(lab, stats, roots, roots_count, h, w, runs); });
  gridDim = dim3(masks);
  for (int m = 0; m < masks; ++m) {
    blockIdx = dim3(m);
    pick(stats, roots, roots_count, h, w, masks, xywh, found, area);
  }
}
