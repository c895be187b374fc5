// The Gaussian Levenberg-Marquardt fit of the BPM estimate, one launch a
// fit, hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package (respmon_tpu/ops/gaussfit.py)
// runs vmap of a while_loop and leaves the loop to XLA. The plain PyTorch
// version (ops/gaussfit.py, _fit_loop) is a host loop over the batch, one
// LM iteration a pass of some thousands of elementwise launches on
// (lanes, W) tensors, in lockstep until the slowest lane stops. This kernel
// was added because that loop, not the arithmetic, set the estimate's time.
//
// Design: one thread a lane (a row of the flattened (lanes, W) batch). A
// lane runs the whole fit without leaving the kernel: the start (first
// valid index, the initial guess, its cost and Jacobian scale, the trust
// radius, the start-done test), up to `iters` LM iterations and the
// convergence test, then writes its parameters, cost, converged flag and
// the number of iterations it ran. Each lane stops at its own stop: no
// lane waits for another, and nothing is read by the host.
//
// Bound: neither bytes nor operations. A fit reads its windows once (a few
// KB) and each lane's work is one serial chain: per iteration three passes
// over W (residuals and Jacobian sums, the trial cost) and, when the
// Gauss-Newton step leaves the trust region, `newton_iters` safeguarded
// Newton steps of 3x3 adjugate solves (the caller passes ops/gaussfit.py's
// _TR_NEWTON_ITERS). The kernel's time is the slowest lane's chain;
// measured times beside the plain loop's: PERF.md. Two exact savings over
// the plain version: the Newton steps run only where their result is used
// (the Gauss-Newton step outside the radius), and the two solves of a
// Newton step share one adjugate of the same matrix.
//
// Numerics: the plain version's arithmetic, operation for operation, so that
// on the card a fit is the plain loop's bit for bit. That is what keeps the
// accept decisions equal: a wild float32 fit (its center far outside the
// window) wanders along its valley, and on which side of the cutoff its dev
// ends follows every last bit. Every expression is written in the plain
// version's order: _gauss as written, _dot3 left to right, _solve3's
// cofactors and its det / scale singularity test, x ** 2 and x ** 3 as
// products, IEEE exp, sqrt and division, NaN-propagating max and min where
// the plain version uses torch.maximum / amax / minimum, and each Python
// constant rounded to T as PyTorch rounds a scalar. Built with -fmad=false,
// so no multiply-add is contracted but those written as fma_. Each sum
// follows the card's kernel for it: PyTorch's reductions (the cost over W,
// the Jacobian's column sums over W, the sums of three), cuBLAS's batched
// gemm (J^T J: fused multiply-adds in sample order) and batched gemv (J^T r:
// an order cuBLAS picks by the batch's size, which the caller passes).
// These orders were read off an H100 under PyTorch 2.11 and CUDA 12.8, for
// W = 20; for other W, or other libraries, the fits stay within rounding of
// the plain loop's.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 64;

__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
__device__ __forceinline__ float abs_(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_(double x) { return fabs(x); }

// torch.maximum / amax and torch.minimum: a NaN on either side wins.
template <typename T>
__device__ __forceinline__ T max_nan(T a, T b) {
  return isnan(a) ? a : isnan(b) ? b : (a > b ? a : b);
}
template <typename T>
__device__ __forceinline__ T min_nan(T a, T b) {
  return isnan(a) ? a : isnan(b) ? b : (a < b ? a : b);
}

template <typename T>
__device__ __forceinline__ T dot3(const T a[3], const T b[3]) {
  return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];
}

template <typename T>
__device__ __forceinline__ T fma_(T a, T b, T c);
template <>
__device__ __forceinline__ float fma_(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
template <>
__device__ __forceinline__ double fma_(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// A sum of three, as PyTorch's reduction kernel adds them on the card (two
// threads: the first holds a + c).
template <typename T>
__device__ __forceinline__ T sum3(T a, T b, T c) {
  return (a + c) + b;
}

// norm(D * v): sqrt of the sum of squares.
template <typename T>
__device__ __forceinline__ T scaled_norm(const T D[3], const T v[3]) {
  const T a = D[0] * v[0], b = D[1] * v[1], c = D[2] * v[2];
  return sqrt_(sum3(a * a, b * b, c * c));
}

// Partial sums combined by halving offsets, as a warp's shuffle-down
// reduction combines them: part[0] += part[n/2], ... (n a power of two).
template <typename T>
__device__ __forceinline__ T halving(T* part, int n) {
  for (int off = n / 2; off > 0; off /= 2)
    for (int l = 0; l < off; ++l) part[l] = part[l] + part[l + off];
  return part[0];
}

// The order in which the plain loop's J^T r (cuBLAS's batched gemv) sums
// over W: `lanes` lanes of `chunk` consecutive samples each (lane l takes
// samples [l*chunk, (l+1)*chunk), then [(lanes+l)*chunk, ...)), fused
// multiply-adds in order within a lane, the lanes combined in order or by
// halving offsets.
struct GemvOrder {
  int lanes, chunk, halving;
};

// _solve3's adjugate of one 3x3 matrix, applied to any right-hand side:
// zeros where the matrix is near singular (a null step).
template <typename T>
struct Adjugate {
  T c[3][3];  // c[i][j]: cofactor (i, j); x_j = sum_i c[i][j] b_i / det
  T det;
  bool ok;

  __device__ explicit Adjugate(const T a[3][3]) {
    c[0][0] = a[1][1] * a[2][2] - a[1][2] * a[2][1];
    c[0][1] = a[1][2] * a[2][0] - a[1][0] * a[2][2];
    c[0][2] = a[1][0] * a[2][1] - a[1][1] * a[2][0];
    det = (a[0][0] * c[0][0] + a[0][1] * c[0][1]) + a[0][2] * c[0][2];
    c[1][0] = a[0][2] * a[2][1] - a[0][1] * a[2][2];
    c[1][1] = a[0][0] * a[2][2] - a[0][2] * a[2][0];
    c[1][2] = a[0][1] * a[2][0] - a[0][0] * a[2][1];
    c[2][0] = a[0][1] * a[1][2] - a[0][2] * a[1][1];
    c[2][1] = a[0][2] * a[1][0] - a[0][0] * a[1][2];
    c[2][2] = a[0][0] * a[1][1] - a[0][1] * a[1][0];
    T scale = abs_(a[0][0]);
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) scale = max_nan(scale, abs_(a[i][j]));
    scale = scale + T(1e-300);  // 0 in float, as PyTorch rounds it
    ok = abs_(det) > T(1e-30) * ((scale * scale) * scale);
  }

  __device__ void solve(const T b[3], T x[3]) const {
    const T den = ok ? det : T(1);
    for (int j = 0; j < 3; ++j) {
      const T v = ((c[0][j] * b[0] + c[1][j] * b[1]) + c[2][j] * b[2]) / den;
      x[j] = ok ? v : T(0);
    }
  }
};

// One lane's window: W samples of t and y, and the mask.
template <typename T>
struct Window {
  const T* t;
  const T* y;
  const unsigned char* m;
  int w;

  __device__ T weight(int i) const { return m[i] ? T(1) : T(0); }

  // exp(-(t_i - c)^2 / (2 s^2)) and t_i - c.
  __device__ T bell(int i, const T p[3], T* d) const {
    *d = t[i] - p[1];
    return exp_(-((*d) * (*d)) / (T(2) * (p[2] * p[2])));
  }

  // Sum of squared weighted residuals (cost_and_resid's cost), in the order
  // of PyTorch's reduction over a contiguous last axis of W < 128: a warp's
  // min(last power of two <= W, 32) threads, thread l taking samples l,
  // l + lanes, ... into four accumulators in turn, then the threads'
  // sums combined by halving offsets.
  __device__ T cost(const T p[3]) const {
    int lanes = 1;
    while (lanes * 2 <= w && lanes < 32) lanes *= 2;
    T part[32];
    for (int l = 0; l < lanes; ++l) {
      T acc[4] = {T(0), T(0), T(0), T(0)};
      for (int i = l, m = 0; i < w; i += lanes, ++m) {
        T d;
        const T r = (p[0] * bell(i, p, &d) - y[i]) * weight(i);
        acc[m & 3] = acc[m & 3] + r * r;
      }
      part[l] = ((acc[0] + acc[1]) + acc[2]) + acc[3];
    }
    return halving(part, lanes);
  }

  // At p: the weighted Jacobian's column sums of squares dd (PyTorch's
  // reduction over a strided axis: one thread, four accumulators in turn),
  // J^T J (cuBLAS's batched gemm: fused multiply-adds in sample order) and
  // J^T r (in `order`).
  __device__ void normal(const T p[3], GemvOrder order, T dd[3], T jj[3][3],
                         T g[3]) const {
    T dacc[4][3], gpart[3][32];
    for (int a = 0; a < 3; ++a) {
      for (int k = 0; k < 4; ++k) dacc[k][a] = T(0);
      for (int l = 0; l < order.lanes; ++l) gpart[a][l] = T(0);
      for (int b = 0; b < 3; ++b) jj[a][b] = T(0);
    }
    const T s2 = p[2] * p[2];
    const T s3 = s2 * p[2];
    for (int i = 0; i < w; ++i) {
      T d;
      const T e = bell(i, p, &d);
      const T wi = weight(i);
      const T r = (p[0] * e - y[i]) * wi;
      const T ae = p[0] * e;
      const T J[3] = {e * wi, ((ae * d) / s2) * wi, ((ae * (d * d)) / s3) * wi};
      const int l = (i / order.chunk) % order.lanes;
      for (int a = 0; a < 3; ++a) {
        dacc[i & 3][a] = dacc[i & 3][a] + J[a] * J[a];
        gpart[a][l] = fma_(J[a], r, gpart[a][l]);
        for (int b = 0; b < 3; ++b) jj[a][b] = fma_(J[a], J[b], jj[a][b]);
      }
    }
    for (int a = 0; a < 3; ++a) {
      dd[a] = ((dacc[0][a] + dacc[1][a]) + dacc[2][a]) + dacc[3][a];
      if (order.halving) {
        g[a] = halving(gpart[a], order.lanes);
      } else {
        g[a] = gpart[a][0];
        for (int l = 1; l < order.lanes; ++l) g[a] = g[a] + gpart[a][l];
      }
    }
  }
};

// JtJ + lam * diag(D*D) + reg * I, as _fit_loop's system(lam) rounds it:
// the off-diagonal terms add lam * 0 and reg * 0.
template <typename T>
__device__ __forceinline__ void system(const T jj[3][3], const T DD[3], T lam,
                                       T reg, T A[3][3]) {
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b)
      A[a][b] = a == b ? (jj[a][b] + lam * DD[a]) + reg * T(1)
                       : (jj[a][b] + lam * T(0)) + reg * T(0);
}

template <typename T>
struct State {
  T p[3], F, D[3], Delta;
};

// One LM iteration of _fit_loop's step(); returns the ftol / xtol stop.
template <typename T>
__device__ bool lm_step(const Window<T>& win, GemvOrder order, State<T>& s,
                        T ftol, T xtol, int newton_iters) {
  T dd[3], jj[3][3], g[3];
  win.normal(s.p, order, dd, jj, g);
  for (int a = 0; a < 3; ++a) s.D[a] = max_nan(s.D[a], sqrt_(dd[a]));
  const T reg = T(1e-10) * sum3(jj[0][0], jj[1][1], jj[2][2]);
  const T DD[3] = {s.D[0] * s.D[0], s.D[1] * s.D[1], s.D[2] * s.D[2]};
  const T neg_g[3] = {-g[0], -g[1], -g[2]};
  T A[3][3];

  T d_gn[3];
  system(jj, DD, T(0), reg, A);
  Adjugate<T>(A).solve(neg_g, d_gn);
  const bool inside = scaled_norm(s.D, d_gn) <= s.Delta;

  T delta[3];
  if (inside) {
    for (int a = 0; a < 3; ++a) delta[a] = d_gn[a];
  } else {
    // Safeguarded Newton on 1/||D d(lam)|| = 1/Delta inside a geometric
    // bracket (MINPACK lmpar's update); its lam is used only out here.
    T lo = T(1e-12), hi = T(1e12);
    T par = sqrt_(lo * hi);
    for (int k = 0; k < newton_iters; ++k) {
      system(jj, DD, par, reg, A);
      const Adjugate<T> adj(A);
      T d[3], q[3], aq[3];
      adj.solve(neg_g, d);
      const T dn = scaled_norm(s.D, d);
      for (int a = 0; a < 3; ++a) q[a] = DD[a] * d[a];
      adj.solve(q, aq);
      const T qv = dot3(q, aq);
      if (dn > s.Delta)
        lo = par;
      else
        hi = par;
      const T cand = par + (((dn - s.Delta) * dn) * dn) / (s.Delta * qv);
      const bool ok = isfinite(cand) && cand > lo && cand < hi && qv > T(0);
      par = ok ? cand : sqrt_(lo * hi);
    }
    system(jj, DD, par, reg, A);
    Adjugate<T>(A).solve(neg_g, delta);
  }

  T p_new[3];
  for (int a = 0; a < 3; ++a) p_new[a] = s.p[a] + delta[a];
  const T F_new = win.cost(p_new);
  const T gd = dot3(g, delta);
  T jd[3];
  for (int a = 0; a < 3; ++a) jd[a] = dot3(jj[a], delta);
  const T pred = -(T(2) * gd + dot3(delta, jd));
  const T actred = s.F - F_new;
  const T ratio = pred > T(0) ? actred / pred : T(0);
  const T pnorm = scaled_norm(s.D, delta);

  // lmdif's radius update: a poor step shrinks the radius to
  // temp * min(Delta, 10*pnorm).
  T temp = actred >= T(0) ? T(0.5) : (T(0.5) * gd) / (gd + T(0.5) * actred);
  if (F_new >= T(100) * s.F) temp = T(0.1);
  if (!isfinite(temp)) temp = T(0.1);
  temp = temp < T(0.1) ? T(0.1) : temp > T(0.5) ? T(0.5) : temp;
  T Delta_new;
  if (ratio <= T(0.25))
    Delta_new = temp * min_nan(s.Delta, T(10) * pnorm);
  else if (ratio >= T(0.75) || inside)
    Delta_new = T(2) * pnorm;
  else
    Delta_new = s.Delta;

  const bool accept = ratio > T(1e-4) && isfinite(p_new[0]) &&
                      isfinite(p_new[1]) && isfinite(p_new[2]) &&
                      isfinite(F_new);
  const bool ftol_hit = accept && abs_(actred) <= ftol * s.F &&
                        pred <= ftol * s.F && ratio <= T(2);
  if (accept) {
    for (int a = 0; a < 3; ++a) s.p[a] = p_new[a];
    s.F = F_new;
  }
  s.Delta = Delta_new;
  const bool xtol_hit = Delta_new <= xtol * scaled_norm(s.D, s.p);
  return ftol_hit || xtol_hit;
}

// out holds 4 rows of `lanes`: ampl, center, dev, cost.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gauss_fit_kernel(const T* __restrict__ t, const T* __restrict__ y,
                     const unsigned char* __restrict__ mask, int lanes, int w,
                     int iters, int newton_iters, GemvOrder order, T ftol,
                     T xtol, T* __restrict__ out,
                     unsigned char* __restrict__ converged,
                     int* __restrict__ steps) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const size_t row = static_cast<size_t>(lane) * w;
  const Window<T> win{t + row, y + row, mask + row, w};

  // The start: peakutils' initial guess [max y, t0, 5 dt] over the first
  // valid samples; its cost and Jacobian scale; the trust radius.
  int nvalid = 0, first = w - 1;
  T ymax = -INFINITY;
  for (int i = 0; i < w; ++i) {
    if (!win.m[i]) continue;
    ++nvalid;
    first = i < first ? i : first;
    ymax = max_nan(ymax, win.y[i]);
  }
  const T t0 = win.t[first];
  const T t1 = win.t[first + 1 < w ? first + 1 : w - 1];
  State<T> s;
  s.p[0] = ymax;
  s.p[1] = t0;
  s.p[2] = (t1 - t0) * T(5);
  s.F = win.cost(s.p);
  {
    T dd[3], jj[3][3], g[3];
    win.normal(s.p, order, dd, jj, g);
    for (int a = 0; a < 3; ++a) {
      const T d0 = sqrt_(dd[a]);
      s.D[a] = d0 == T(0) ? T(1) : d0;
    }
  }
  s.Delta = T(100) * scaled_norm(s.D, s.p);
  if (s.Delta == T(0)) s.Delta = T(100);

  bool done = nvalid < 3 || !isfinite(s.F);
  int k = 0;
  for (; k < iters && !done; ++k)
    done = lm_step(win, order, s, ftol, xtol, newton_iters);

  const bool finite = isfinite(s.p[0]) && isfinite(s.p[1]) &&
                      isfinite(s.p[2]) && isfinite(s.F);
  out[lane] = s.p[0];
  out[lanes + lane] = s.p[1];
  out[2 * lanes + lane] = s.p[2];
  out[3 * lanes + lane] = s.F;
  converged[lane] = done && finite && nvalid >= 3;
  steps[lane] = k;
}

template <typename T>
int launch(const void* t, const void* y, const void* mask, int lanes, int w,
           int iters, int newton_iters, GemvOrder order, double ftol,
           double xtol, void* out, void* converged, void* steps,
           void* stream) {
  if (lanes < 0 || w < 1 || order.lanes < 1 || order.lanes > 32 ||
      (order.lanes & (order.lanes - 1)) != 0 || order.chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (lanes == 0) return 0;
  gauss_fit_kernel<T><<<(lanes + kThreads - 1) / kThreads, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(t), static_cast<const T*>(y),
      static_cast<const unsigned char*>(mask), lanes, w, iters, newton_iters,
      order, static_cast<T>(ftol), static_cast<T>(xtol), static_cast<T*>(out),
      static_cast<unsigned char*>(converged), static_cast<int*>(steps));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The fit of `lanes` windows of `w` samples: t, y (lanes, w) of float or
// double and mask (lanes, w) of bytes 0 / 1, all contiguous. Writes out
// (4, lanes): ampl, center, dev, cost; converged (lanes) bytes; steps
// (lanes) int32, the LM iterations each lane ran. newton_iters is the
// safeguarded Newton steps of each iteration's trust-region solve;
// gemv_lanes (a power of two up to 32), gemv_chunk and gemv_halving the
// order of J^T r's sum (GemvOrder); ftol and xtol are rounded to the type.
// Returns the launch's cudaError_t.
extern "C" int gauss_fit_f32(const void* t, const void* y, const void* mask,
                             int lanes, int w, int iters, int newton_iters,
                             int gemv_lanes, int gemv_chunk, int gemv_halving,
                             double ftol, double xtol, void* out,
                             void* converged, void* steps, void* stream) {
  return launch<float>(t, y, mask, lanes, w, iters, newton_iters,
                       GemvOrder{gemv_lanes, gemv_chunk, gemv_halving}, ftol,
                       xtol, out, converged, steps, stream);
}

extern "C" int gauss_fit_f64(const void* t, const void* y, const void* mask,
                             int lanes, int w, int iters, int newton_iters,
                             int gemv_lanes, int gemv_chunk, int gemv_halving,
                             double ftol, double xtol, void* out,
                             void* converged, void* steps, void* stream) {
  return launch<double>(t, y, mask, lanes, w, iters, newton_iters,
                        GemvOrder{gemv_lanes, gemv_chunk, gemv_halving}, ftol,
                        xtol, out, converged, steps, stream);
}
