// The largest connected component's bounding box of a batch of masks, as a
// union-find written by hand for Hopper (sm_90a): six kernels a batch, no
// host read.
//
// Replaces no TPU kernel: the JAX package (respmon_tpu/ops/ccl.py) labels
// by XLA compositions of neighbour mins and scans. The plain PyTorch
// version (ops/ccl.py, _largest_component_bbox) sweeps such compositions
// to a fixed point, some 170 launches and one host read of `changed` a
// sweep, one mask at a time; this kernel was added because that loop, not
// the work, set the time of every localize and calibration.
//
// It computes what the plain version computes, bit for bit:
//   1. Hole fill: a union-find over the background with 4-connectivity, in
//      which every background pixel on the image border links to a virtual
//      root, -1, "outside". filled = fg | the background not under -1.
//   2. Labels: a union-find over `filled` with 8-connectivity, each link an
//      atomicMin towards the smaller index, so that every root is the
//      smallest flat index of its component (label_components' label),
//      whatever order the unions run in.
//   3. Per root: the pixels, cv2's polygon area in halves (each 2x2 quad of
//      `filled` adds 2 if all four are filled, 1 if three are, to the label
//      of its filled pixels, which are all one component), and the box.
//      Integer atomics: the sums are exact and do not depend on the order.
//   4. Per mask: the root of the largest area, the smallest on a tie, as
//      torch.argmax keeps the first; with no root, the plain version's
//      argmax 0: box (W, H, -W, -H), found false, area -inf.
// The area is area2 / 2 in float32, which is the plain version's float32
// sum of halves while every partial sum stays below 2^23 (the caller
// bounds H * W).
//
// Design: steps 1 and 2 each resolve a tile of kTileH x kTileW pixels in
// shared memory first (one block a tile, local indices, whose order is the
// flat order within a tile), write each pixel's tile root as a flat index,
// then a pass over the whole batch unites the pixels that neighbour across
// a tile edge, in device memory. A 68 x 120 mask (a 1080p frame at level 4)
// is one tile, and its merge pass finds no edge. Step 3 resolves each
// pixel's root by following the links (a run of pixels with one tile root
// reads them once) and adds a row run's sums in registers before its
// atomics. Step 4 is one block a mask over the list of roots step 3 made.
//
// Bound: the bytes (the masks read once, the results written once: under
// a microsecond at the main path's shapes), far below its time. What takes
// the time is label_tiles: each background pixel's find through the hole
// fill's forest in device memory, then a tile's unions, which wait on one
// another (measured times beside the plain loop's: PERF.md).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kTileH = 72;   // 68 coarse rows of a 1080p frame in one tile
constexpr int kTileW = 128;  // 9216 int32 labels: 36 KB of static shared
constexpr int kTileThreads = 512;
constexpr int kThreads = 256;
constexpr int kRun = 32;     // pixels of a row a thread of step 3 takes
constexpr int kOutside = -1;         // the hole fill's virtual root
constexpr int kNone = INT_MAX;       // a tile pixel outside the union-find
constexpr int kStats = 6;            // npix, area2, x0, x1, y0, y1 a root

// Links in shared memory, read past the compiler's caches.
struct SharedForest {
  int* p;
  __device__ __forceinline__ int get(int i) const {
    return *static_cast<volatile int*>(p + i);
  }
  __device__ __forceinline__ void set(int i, int to) const {
    *static_cast<volatile int*>(p + i) = to;
  }
  __device__ __forceinline__ int link(int i, int to) const {
    return atomicMin(p + i, to);
  }
};

// Links in device memory, read from L2 (another block's atomics are not
// in this SM's L1).
struct GlobalForest {
  int* p;
  __device__ __forceinline__ int get(int i) const { return __ldcg(p + i); }
  __device__ __forceinline__ void set(int i, int to) const {
    __stcg(p + i, to);
  }
  __device__ __forceinline__ int link(int i, int to) const {
    return atomicMin(p + i, to);
  }
};

// Links in device memory that no thread of the kernel changes.
struct ConstForest {
  const int* p;
  __device__ __forceinline__ int get(int i) const { return __ldg(p + i); }
  __device__ __forceinline__ void set(int, int) const {}
};

// The root of i: links point to smaller indices, a root to itself, and -1
// (the outside) has no entry. On the way each link skips to its
// grandparent (path halving), so that chains built by concurrent unions (a
// row linked pixel by pixel is one chain) do not stay long. Such a store
// only ever points a pixel at one of its ancestors; where it overwrites a
// concurrent atomicMin on a pixel that was no longer a root, that unite
// did not count on its link and goes on from the old parent.
template <typename Forest>
__device__ __forceinline__ int find_root(const Forest& f, int i) {
  while (i >= 0) {
    const int up = f.get(i);
    if (up == i) break;
    if (up < 0) return up;
    const int next = f.get(up);
    if (next != up) f.set(i, next);
    i = next;
  }
  return i;
}

// Joins the trees of a and b: the larger root links to the smaller. If
// another thread linked that root first, the atomic returns where it went
// and the join goes on from there.
template <typename Forest>
__device__ void unite(const Forest& f, int a, int b) {
  a = find_root(f, a);
  b = find_root(f, b);
  while (a != b) {
    if (a < b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = f.link(a, b);  // a > b >= -1: a has an entry
    if (old == a) return;
    a = find_root(f, old);
    b = find_root(f, b);
  }
}

struct Tile {
  int y0, x0, th, tw;
  size_t base;  // the mask's first pixel in the batch
  __device__ Tile(int h, int w)
      : y0(blockIdx.y * kTileH),
        x0(blockIdx.x * kTileW),
        th(min(kTileH, h - static_cast<int>(blockIdx.y) * kTileH)),
        tw(min(kTileW, w - static_cast<int>(blockIdx.x) * kTileW)),
        base(static_cast<size_t>(blockIdx.z) * h * w) {}
  // The flat index in the mask of local index i.
  __device__ int flat(int i, int w) const {
    return (y0 + i / kTileW) * w + x0 + i % kTileW;
  }
  __device__ bool holds(int i) const {
    return i / kTileW < th && i % kTileW < tw;
  }
};

// Step 1 within a tile: each background pixel's tile root (or -1) into
// `par`. Pixels of the foreground keep no entry there. Also zeroes the
// mask's count of roots.
__global__ void __launch_bounds__(kTileThreads)
holes_tiles(const unsigned char* fg, int* par, int* roots_count, int h,
            int w) {
  __shared__ int links[kTileH * kTileW];
  const Tile t(h, w);
  const unsigned char* m = fg + t.base;
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0)
    roots_count[blockIdx.z] = 0;
  for (int i = threadIdx.x; i < kTileH * kTileW; i += blockDim.x) {
    int v = kNone;
    if (t.holds(i)) {
      const int y = t.y0 + i / kTileW, x = t.x0 + i % kTileW;
      if (!m[y * w + x])
        v = (y == 0 || x == 0 || y == h - 1 || x == w - 1) ? kOutside : i;
    }
    links[i] = v;
  }
  __syncthreads();
  const SharedForest f{links};
  for (int i = threadIdx.x; i < kTileH * kTileW; i += blockDim.x) {
    if (f.get(i) == kNone) continue;
    const int ly = i / kTileW, lx = i % kTileW;
    if (lx > 0 && f.get(i - 1) != kNone) unite(f, i, i - 1);
    if (ly > 0 && f.get(i - kTileW) != kNone) unite(f, i, i - kTileW);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTileH * kTileW; i += blockDim.x) {
    if (f.get(i) == kNone) continue;
    const int r = find_root(f, i);
    links[i] = r;
    par[t.base + t.flat(i, w)] = r < 0 ? kOutside : t.flat(r, w);
  }
}

// Step 1 across tiles: unites background pixels 4-adjacent across a tile
// edge.
__global__ void __launch_bounds__(kThreads)
holes_merge(const unsigned char* fg, int* par, int h, int w, size_t n) {
  const int hw = h * w;
  for (size_t k = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       k < n; k += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int p = static_cast<int>(k % hw);
    const int y = p / w, x = p % w;
    const bool top = y > 0 && y % kTileH == 0;
    const bool left = x > 0 && x % kTileW == 0;
    if (!(top || left) || fg[k]) continue;
    const GlobalForest f{par + (k - p)};
    if (top && !fg[k - w]) unite(f, p, p - w);
    if (left && !fg[k - 1]) unite(f, p, p - 1);
  }
}

// Step 2 within a tile: `filled` from the hole fill's forest, its
// 8-connected tile roots into `lab` (-1 where not filled), and the
// statistics of every tile root set to empty (a mask's roots are among its
// tiles' roots).
__global__ void __launch_bounds__(kTileThreads)
label_tiles(const unsigned char* fg, const int* par, int* lab, int* stats,
            int h, int w) {
  __shared__ int links[kTileH * kTileW];
  const Tile t(h, w);
  const unsigned char* m = fg + t.base;
  const ConstForest holes{par + t.base};
  for (int i = threadIdx.x; i < kTileH * kTileW; i += blockDim.x) {
    int v = kNone;
    if (t.holds(i)) {
      const int p = t.flat(i, w);
      if (m[p] || find_root(holes, p) != kOutside) v = i;
    }
    links[i] = v;
  }
  __syncthreads();
  const SharedForest f{links};
  for (int i = threadIdx.x; i < kTileH * kTileW; i += blockDim.x) {
    if (f.get(i) == kNone) continue;
    const int ly = i / kTileW, lx = i % kTileW;
    if (lx > 0 && f.get(i - 1) != kNone) unite(f, i, i - 1);
    if (ly > 0) {
      const int up = i - kTileW;
      if (lx > 0 && f.get(up - 1) != kNone) unite(f, i, up - 1);
      if (f.get(up) != kNone) unite(f, i, up);
      if (lx + 1 < t.tw && f.get(up + 1) != kNone) unite(f, i, up + 1);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTileH * kTileW; i += blockDim.x) {
    if (!t.holds(i)) continue;
    const int p = t.flat(i, w);
    if (f.get(i) == kNone) {
      lab[t.base + p] = -1;
      continue;
    }
    const int r = find_root(f, i);
    links[i] = r;
    lab[t.base + p] = t.flat(r, w);
    if (r == i) {
      int* s = stats + kStats * (t.base + p);
      s[0] = 0;
      s[1] = 0;
      s[2] = INT_MAX;
      s[3] = -1;
      s[4] = INT_MAX;
      s[5] = -1;
    }
  }
}

// Step 2 across tiles: unites filled pixels 8-adjacent across a tile edge
// (each pair once: a pixel with its left, up-left, up and up-right).
__global__ void __launch_bounds__(kThreads)
label_merge(int* lab, int h, int w, size_t n) {
  const int hw = h * w;
  for (size_t k = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       k < n; k += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int p = static_cast<int>(k % hw);
    const int y = p / w, x = p % w;
    const bool top = y > 0 && y % kTileH == 0;
    const bool left = x > 0 && x % kTileW == 0;
    const bool right = y > 0 && x + 1 < w && (x + 1) % kTileW == 0;
    if (!(top || left || right)) continue;
    const GlobalForest f{lab + (k - p)};
    if (f.get(p) < 0) continue;
    if (left && f.get(p - 1) >= 0) unite(f, p, p - 1);
    if (y > 0) {
      const int up = p - w;
      if (x > 0 && (top || left) && f.get(up - 1) >= 0) unite(f, p, up - 1);
      if (top && f.get(up) >= 0) unite(f, p, up);
      if (x + 1 < w && (top || right) && f.get(up + 1) >= 0)
        unite(f, p, up + 1);
    }
  }
}

// A row run's sums for one root, added to the root's statistics at once.
struct RunSums {
  int root = -1, npix = 0, area2 = 0, x0 = INT_MAX, x1 = -1;

  __device__ void flush(int* stats, int y) {
    if (root < 0) return;
    int* s = stats + static_cast<size_t>(kStats) * root;
    if (area2) atomicAdd(s + 1, area2);
    if (npix) {
      atomicAdd(s, npix);
      atomicMin(s + 2, x0);
      atomicMax(s + 3, x1);
      atomicMin(s + 4, y);
      atomicMax(s + 5, y);
    }
  }
  __device__ void to(int r, int* stats, int y) {
    if (r == root) return;
    flush(stats, y);
    root = r;
    npix = area2 = 0;
    x0 = INT_MAX;
    x1 = -1;
  }
};

// Step 3: each filled pixel's root, its pixel and box to that root, each
// quad's area to the root of its filled pixels, and each root to its
// mask's list. A thread takes kRun pixels of a row and the quads whose
// top-left corner they are.
__global__ void __launch_bounds__(kThreads)
accumulate(const int* lab, int* stats, int* roots, int* roots_count, int h,
           int w, size_t runs) {
  const int runs_a_row = (w + kRun - 1) / kRun;
  const size_t runs_a_mask = static_cast<size_t>(h) * runs_a_row;
  for (size_t k = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       k < runs; k += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t mask = k / runs_a_mask;
    const int j = static_cast<int>(k % runs_a_mask);
    const int y = j / runs_a_row;
    const int xa = (j % runs_a_row) * kRun, xb = min(xa + kRun, w);
    const size_t base = mask * h * w;
    const ConstForest f{lab + base};
    int* st = stats + kStats * base;
    RunSums sums;
    int key = -1, key_root = -1;  // the last tile root looked up
    auto root_of = [&](int l) {
      if (l != key) {
        key = l;
        key_root = find_root(f, l);
      }
      return key_root;
    };
    for (int x = xa; x < xb; ++x) {
      const int p = y * w + x;
      const int l = f.get(p);
      if (l >= 0) {
        const int r = root_of(l);
        sums.to(r, st, y);
        ++sums.npix;
        sums.x0 = min(sums.x0, x);
        sums.x1 = max(sums.x1, x);
        if (r == p) roots[base + atomicAdd(roots_count + mask, 1)] = p;
      }
      if (y + 1 < h && x + 1 < w) {
        const int lr = f.get(p + 1);
        const int q = (l >= 0) + (lr >= 0) + (f.get(p + w) >= 0) +
                      (f.get(p + w + 1) >= 0);
        if (q >= 3) {
          sums.to(root_of(l >= 0 ? l : lr), st, y);
          sums.area2 += q == 4 ? 2 : 1;
        }
      }
    }
    sums.flush(st, y);
  }
}

// Step 4: one block a mask picks its root of the largest area (the
// smallest root on a tie) and writes the box, found and the area.
__global__ void __launch_bounds__(kThreads)
pick(const int* stats, const int* roots, const int* roots_count, int h,
     int w, int masks, int* xywh, unsigned char* found, float* area) {
  __shared__ unsigned long long warp_best[kThreads / 32];
  const int mask = blockIdx.x;
  const size_t base = static_cast<size_t>(mask) * h * w;
  const int n = roots_count[mask];
  // area2 in the high word, ~root in the low: the largest key is the
  // largest area, then the smallest root; 0 is no root.
  unsigned long long best = 0;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const int r = roots[base + k];
    const unsigned long long key =
        (static_cast<unsigned long long>(stats[kStats * (base + r) + 1])
         << 32) |
        static_cast<unsigned int>(~r);
    best = key > best ? key : best;
  }
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long other = __shfl_down_sync(0xffffffffu, best, off);
    best = other > best ? other : best;
  }
  if (threadIdx.x % 32 == 0) warp_best[threadIdx.x / 32] = best;
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (unsigned i = 1; i < (blockDim.x + 31) / 32; ++i)
    best = warp_best[i] > best ? warp_best[i] : best;
  int x = w, y = h, bw = -w, bh = -h;
  float a = -INFINITY;
  if (n > 0) {
    const int r = static_cast<int>(~static_cast<unsigned int>(best));
    const int* s = stats + kStats * (base + r);
    x = s[2];
    y = s[4];
    bw = s[3] - s[2] + 1;
    bh = s[5] - s[4] + 1;
    a = 0.5f * static_cast<float>(best >> 32);
  }
  xywh[mask] = x;
  xywh[masks + mask] = y;
  xywh[2 * masks + mask] = bw;
  xywh[3 * masks + mask] = bh;
  found[mask] = n > 0;
  area[mask] = a;
}

unsigned int blocks_for(size_t threads) {
  return static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
}

}  // namespace

// The largest 8-connected component's box, after filling holes, of each of
// `masks` (h, w) masks of bytes 0 / 1 at `fg`, contiguous. `work` holds
// 9 * masks * h * w + masks int32 of scratch. Writes xywh (4, masks) int32:
// x, y, w, h; found (masks) bytes; area (masks) float32. Six kernels on
// `stream`, no synchronise. Returns the first failing launch's cudaError_t,
// cudaErrorInvalidValue for shapes out of range (h * w of 2^23 or more,
// more than 65535 masks, 2^31 pixels or more), else 0.
extern "C" int ccl_largest_bbox(const void* fg, int masks, int h, int w,
                                void* work, void* xywh, void* found,
                                void* area, void* stream) {
  if (masks < 1 || masks > 65535 || h < 1 || w < 1 ||
      static_cast<long long>(h) * w >= (1LL << 23) ||
      static_cast<long long>(masks) * h * w >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t n = static_cast<size_t>(masks) * h * w;
  int* par = static_cast<int*>(work);
  int* lab = par + n;
  int* stats = lab + n;
  int* roots = stats + kStats * n;
  int* roots_count = roots + n;
  const unsigned char* m = static_cast<const unsigned char*>(fg);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 tiles((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH,
                   masks);
  const size_t runs =
      static_cast<size_t>(masks) * h * ((w + kRun - 1) / kRun);
  cudaError_t err;
  holes_tiles<<<tiles, kTileThreads, 0, s>>>(m, par, roots_count, h, w);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  holes_merge<<<blocks_for(n), kThreads, 0, s>>>(m, par, h, w, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  label_tiles<<<tiles, kTileThreads, 0, s>>>(m, par, lab, stats, h, w);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  label_merge<<<blocks_for(n), kThreads, 0, s>>>(lab, h, w, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  accumulate<<<blocks_for(runs), kThreads, 0, s>>>(lab, stats, roots,
                                                   roots_count, h, w, runs);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  pick<<<masks, kThreads, 0, s>>>(stats, roots, roots_count, h, w, masks,
                                  static_cast<int*>(xywh),
                                  static_cast<unsigned char*>(found),
                                  static_cast<float*>(area));
  return static_cast<int>(cudaGetLastError());
}
