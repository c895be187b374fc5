"""Batched Gaussian curve fitting: MINPACK-style trust-region LM.

Port of ``respmon_tpu/ops/gaussfit.py`` (reference base.py:327 ->
peakutils.gaussian_fit -> scipy.optimize.curve_fit).  Fits
``ampl * exp(-(t-center)^2 / (2 dev^2))`` to every masked window of a
(B, W) batch at once.  The JAX package runs ``vmap`` of a ``while_loop``.
Here a CUDA tensor takes one launch of ``csrc/gaussfit.cu`` a fit, one
thread a lane, each lane running to its own stop on the card; a CPU tensor
takes the plain version, ``_fit_loop``: one masked loop over the batch in
which a lane stops updating once it is done, and the loop stops when no
lane is live (one host read of the live lanes' count per iteration).
Lanes that can never converge (fewer than 3 valid points, non-finite
initial cost) start done.  Only the analytic jacobian is ported; the
forward-difference variant is reached by no production path.

The f32 loop stops at a loose ftol (3.45e-4), so on noisy windows its
stopping point moves with last-ULP differences (XLA's and PyTorch's
``exp`` differ): params may land ~1% from the JAX package's while the
accept/reject decisions agree.  The kernel does the plain loop's
arithmetic in the card's order (its sums as PyTorch's reductions and
cuBLAS sum them there), so that a wild fit, which wanders along its valley
to wherever the last bits take it, ends where the plain loop's does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from respmon_tpu_torch.ops import _build
from respmon_tpu_torch.utils.bench import span

# Safeguarded Newton steps of the trust-region lambda solve per LM step,
# in the plain loop and in csrc/gaussfit.cu (passed to each launch).
_TR_NEWTON_ITERS = 16

# csrc/gaussfit.cu: one launch a fit on a CUDA tensor, counted as gauss_fit.
_FIT_ARGS = "ppp" + "i" * 7 + "dd" + "ppp"
KERNELS = _build.Kernels("gaussfit", {"gauss_fit_f32": _FIT_ARGS,
                                      "gauss_fit_f64": _FIT_ARGS},
                         counted=("gauss_fit",))

# The order in which the plain loop's J^T r (cuBLAS's batched gemv) sums
# over W = 20 on an H100 under PyTorch 2.11 and CUDA 12.8, which cuBLAS
# picks by the batch's size: (most lanes, (lanes, chunk, halving)) as
# csrc/gaussfit.cu's GemvOrder takes it.  Read off the card at 12 to 3072
# lanes; between two readings the next one's order is taken.
_GEMV_W = 20
_GEMV_ORDERS = {
    torch.float32: ((120, (8, 4, 1)), (768, (2, 10, 0)), (1152, (4, 5, 0)),
                    (2304, (2, 1, 0)), (None, (2, 10, 0))),
    torch.float64: ((12, (4, 5, 1)), (768, (2, 1, 0)), (960, (2, 10, 0)),
                    (1536, (2, 1, 0)), (None, (1, 1, 0))),
}


class GaussFit(NamedTuple):
    ampl: torch.Tensor
    center: torch.Tensor
    dev: torch.Tensor
    converged: torch.Tensor   # bool — False is the RuntimeError analog
    cost: torch.Tensor


def _gauss(t, ampl, center, dev):
    return ampl * torch.exp(-((t - center) ** 2) / (2.0 * dev ** 2))


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (length 3), left to right."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) \
        + a[..., 2] * b[..., 2]


def _solve3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Closed-form (..., 3, 3) solve via the adjugate; zeros for
    near-singular systems (a null step for the trust-region loop)."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    det = a00 * c00 + a01 * c01 + a02 * c02
    c10 = a02 * a21 - a01 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a01 * a20 - a00 * a21
    c20 = a01 * a12 - a02 * a11
    c21 = a02 * a10 - a00 * a12
    c22 = a00 * a11 - a01 * a10
    adjT = torch.stack([torch.stack([c00, c10, c20], -1),
                        torch.stack([c01, c11, c21], -1),
                        torch.stack([c02, c12, c22], -1)], -2)
    scale = A.abs().amax(dim=(-2, -1)) + 1e-300
    ok = det.abs() > 1e-30 * scale ** 3
    x = _dot3(adjT, b[..., None, :]) / torch.where(ok, det, 1.0)[..., None]
    return torch.where(ok[..., None], x, torch.zeros_like(b))


def gaussian_fit_batch(t: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                       iters: int = 200) -> GaussFit:
    """Trust-region LM fit of a Gaussian to each masked (B, W) window.

    Initial guess as peakutils.gaussian_fit: ``[max(y), t[0], 5*dt]`` over
    the first valid samples.  Tolerances are sqrt(machine eps) of the
    dtype (MINPACK's 1.49e-8 in f64; 3.45e-4 in f32, the f32 roundoff
    floor).  Params and cost of non-converged lanes are unspecified."""
    return _fit(t, y, mask, iters, None, None)


def gaussian_fit_single(t: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                        iters: int = 200, ftol: float | None = None,
                        xtol: float | None = None) -> GaussFit:
    """The fit of one masked (W,) window, a ``GaussFit`` of 0-d tensors:
    ``gaussian_fit_batch`` at B = 1, with ``ftol`` / ``xtol`` in place of
    the dtype's default tolerance where given."""
    fit = _fit(t[None], y[None], mask[None], iters, ftol, xtol)
    return GaussFit(*(f[0] for f in fit))


def _fit(t, y, mask, iters: int, ftol, xtol) -> GaussFit:
    """The fit in its ``bpm.fit`` span: the plain loop for CPU tensors (one
    ``bpm.lm_step`` span an iteration), the kernel for CUDA tensors; a
    ``None`` tolerance is the dtype's default."""
    with span("bpm.fit") as rec:
        if all(x.device.type == "cpu" for x in (t, y, mask)):
            return _fit_loop(t, y, mask, iters, ftol, xtol, rec)
        return _fit_cuda(t, y, mask, iters, ftol, xtol, rec)


def _gemv_order(dtype, lanes: int, w: int) -> tuple:
    """The kernel's order for J^T r's sum over W: the plain loop's on the
    card where it was read (``_GEMV_ORDERS``), else in sample order."""
    if w != _GEMV_W:
        return (1, 1, 0)
    for most, order in _GEMV_ORDERS[dtype]:
        if most is None or lanes <= most:
            return order


def _tolerances(dtype, ftol, xtol):
    """(ftol, xtol), a ``None`` one the dtype's sqrt(machine eps)."""
    tol = 1.49e-8 if dtype == torch.float64 else 3.45e-4
    return (tol if ftol is None else ftol), (tol if xtol is None else xtol)


def _check_cuda(t, y, mask) -> None:
    if y.device.type != "cuda" or t.device != y.device \
            or mask.device != y.device:
        raise ValueError(f"gaussfit: expected t, y and mask on one CUDA "
                         f"device or all on the CPU, got {t.device}, "
                         f"{y.device}, {mask.device}")
    if y.dtype not in (torch.float32, torch.float64) or t.dtype != y.dtype:
        raise TypeError(f"gaussfit: expected t and y of one float type "
                        f"(float32 or float64), got {t.dtype}, {y.dtype}")
    if mask.dtype != torch.bool:
        raise TypeError(f"gaussfit: expected a bool mask, got {mask.dtype}")
    if t.shape != y.shape or mask.shape != y.shape or y.ndim < 1 \
            or y.shape[-1] < 1:
        raise ValueError(f"gaussfit: expected t, y and mask of one (..., W) "
                         f"shape with W >= 1, got {tuple(t.shape)}, "
                         f"{tuple(y.shape)}, {tuple(mask.shape)}")
    if not (t.is_contiguous() and y.is_contiguous()
            and mask.is_contiguous()):
        raise ValueError("gaussfit: expected contiguous t, y and mask")
    if y.numel() // y.shape[-1] >= 2 ** 31:
        raise ValueError(f"gaussfit: {y.numel() // y.shape[-1]} lanes "
                         f"exceed the kernel's int32 lane index")


def _fit_cuda(t, y, mask, iters: int, ftol, xtol, rec) -> GaussFit:
    """``_fit``'s body on the card: one launch of ``csrc/gaussfit.cu`` on
    the current stream, no synchronise.  While ``rec`` records, one host
    read of the lanes' iteration counts sets the counts ``_fit_loop``
    sets: ``lanes`` live at the start, ``steps`` (the most any lane ran,
    what the lockstep loop would run) and ``live_lane_steps``."""
    _check_cuda(t, y, mask)
    ftol, xtol = _tolerances(y.dtype, ftol, xtol)
    batch, w = y.shape[:-1], y.shape[-1]
    lanes = y.numel() // w
    out = torch.empty((4, lanes), dtype=y.dtype, device=y.device)
    converged = torch.empty(lanes, dtype=torch.bool, device=y.device)
    steps = torch.empty(lanes, dtype=torch.int32, device=y.device)
    if lanes:
        KERNELS.launch(
            "gauss_fit_f32" if y.dtype == torch.float32 else "gauss_fit_f64",
            y.device, t.data_ptr(), y.data_ptr(), mask.data_ptr(), lanes, w,
            iters, _TR_NEWTON_ITERS, *_gemv_order(y.dtype, lanes, w), ftol,
            xtol, out.data_ptr(), converged.data_ptr(), steps.data_ptr(),
            count="gauss_fit")
    if rec.recording:
        c = steps.cpu()
        rec.set(lanes=int((c > 0).sum()),
                steps=int(c.max()) if lanes else 0,
                live_lane_steps=int(c.sum()))
    ampl, center, dev, cost = (row.view(batch) for row in out)
    return GaussFit(ampl=ampl, center=center, dev=dev,
                    converged=converged.view(batch), cost=cost)


def _fit_loop(t, y, mask, iters: int, ftol, xtol, rec) -> GaussFit:
    """``_fit``'s body; sets ``rec``'s counts: ``lanes`` live at the start,
    ``steps`` run and ``live_lane_steps`` (live lanes summed over the
    steps)."""
    dtype = y.dtype
    dev = y.device
    ftol, xtol = _tolerances(dtype, ftol, xtol)
    w = mask.to(dtype)
    nvalid = mask.sum(dim=-1)
    npts = t.shape[-1]

    idx = torch.arange(npts, device=dev)
    first = torch.where(mask, idx, npts - 1).amin(dim=-1, keepdim=True)
    t0 = torch.gather(t, -1, first)[..., 0]
    t1 = torch.gather(t, -1, (first + 1).clamp(max=npts - 1))[..., 0]
    ymax = torch.where(mask, y, -torch.inf).amax(dim=-1)
    p0 = torch.stack([ymax, t0, (t1 - t0) * 5.0], dim=-1)
    diag3 = torch.eye(3, dtype=dtype, device=dev)

    def cost_and_resid(p):
        r = (_gauss(t, p[..., 0:1], p[..., 1:2], p[..., 2:3]) - y) * w
        return (r * r).sum(dim=-1), r

    def jacobian(p):
        ampl, center, sd = p[..., 0:1], p[..., 1:2], p[..., 2:3]
        d = t - center
        e = torch.exp(-(d ** 2) / (2.0 * sd ** 2))
        cols = torch.stack([e, ampl * e * d / (sd ** 2),
                            ampl * e * (d ** 2) / (sd ** 3)], dim=-1)
        return cols * w[..., None]

    def norm(v):
        return torch.sqrt((v * v).sum(dim=-1))

    F0, _ = cost_and_resid(p0)
    J0 = jacobian(p0)
    D0 = torch.sqrt((J0 * J0).sum(dim=-2))
    D0 = torch.where(D0 == 0, 1.0, D0)
    Delta0 = 100.0 * norm(D0 * p0)
    Delta0 = torch.where(Delta0 == 0, 100.0, Delta0)

    def step(p, F, D, Delta):
        _, r = cost_and_resid(p)
        J = jacobian(p)
        D = torch.maximum(D, torch.sqrt((J * J).sum(dim=-2)))
        Jt = J.transpose(-1, -2)
        JtJ = torch.matmul(Jt, J)
        g = torch.matmul(Jt, r[..., None])[..., 0]
        reg = (1e-10 * JtJ.diagonal(dim1=-2, dim2=-1).sum(-1))[..., None,
                                                               None] * diag3
        DD = torch.diag_embed(D * D)

        def system(lam):
            return JtJ + lam[..., None, None] * DD + reg

        d_gn = _solve3(system(torch.zeros_like(F)), -g)
        inside = norm(D * d_gn) <= Delta

        # Safeguarded Newton on 1/||D d(lam)|| = 1/Delta (MINPACK lmpar's
        # update) inside a geometric bracket.
        lo = torch.full_like(F, 1e-12)
        hi = torch.full_like(F, 1e12)
        par = torch.sqrt(lo * hi)
        for _ in range(_TR_NEWTON_ITERS):
            A = system(par)
            d = _solve3(A, -g)
            dn = norm(D * d)
            q = (D * D) * d
            qv = _dot3(q, _solve3(A, q))
            root_above = dn > Delta
            lo = torch.where(root_above, par, lo)
            hi = torch.where(root_above, hi, par)
            cand = par + (dn - Delta) * dn * dn / (Delta * qv)
            ok = torch.isfinite(cand) & (cand > lo) & (cand < hi) & (qv > 0)
            par = torch.where(ok, cand, torch.sqrt(lo * hi))
        delta = torch.where(inside[..., None], d_gn,
                            _solve3(system(par), -g))

        p_new = p + delta
        F_new, _ = cost_and_resid(p_new)
        gd = _dot3(g, delta)
        pred = -(2.0 * gd
                 + _dot3(delta, _dot3(JtJ, delta[..., None, :])))
        actred = F - F_new
        ratio = torch.where(pred > 0,
                            actred / torch.where(pred > 0, pred, 1.0), 0.0)
        pnorm = norm(D * delta)

        # lmdif's radius update: a poor step shrinks the radius to
        # temp * min(Delta, 10*pnorm).
        temp = torch.where(actred >= 0, 0.5,
                           0.5 * gd / (gd + 0.5 * actred))
        temp = torch.where(F_new >= 100.0 * F, 0.1, temp)
        temp = torch.where(torch.isfinite(temp), temp, 0.1)
        temp = temp.clamp(0.1, 0.5)
        Delta_new = torch.where(
            ratio <= 0.25, temp * torch.minimum(Delta, 10.0 * pnorm),
            torch.where((ratio >= 0.75) | inside, 2.0 * pnorm, Delta))
        accept = (ratio > 1e-4) & torch.isfinite(p_new).all(dim=-1) \
            & torch.isfinite(F_new)
        ftol_hit = accept & ((actred).abs() <= ftol * F) \
            & (pred <= ftol * F) & (ratio <= 2.0)
        p_acc = torch.where(accept[..., None], p_new, p)
        F_acc = torch.where(accept, F_new, F)
        xtol_hit = Delta_new <= xtol * norm(D * p_acc)
        return p_acc, F_acc, D, Delta_new, ftol_hit | xtol_hit

    p, F, D, Delta = p0, F0, D0, Delta0
    done = (nvalid < 3) | ~torch.isfinite(F0)
    lanes = steps = live_lane_steps = 0
    for k in range(iters):
        live = ~done
        n_live = int(live.sum())
        if k == 0:
            lanes = n_live
        if n_live == 0:
            break
        with span("bpm.lm_step"):
            p_n, F_n, D_n, Delta_n, hit = step(p, F, D, Delta)
            p = torch.where(live[..., None], p_n, p)
            F = torch.where(live, F_n, F)
            D = torch.where(live[..., None], D_n, D)
            Delta = torch.where(live, Delta_n, Delta)
            done = done | (live & hit)
        steps += 1
        live_lane_steps += n_live
    rec.set(lanes=lanes, steps=steps, live_lane_steps=live_lane_steps)

    finite = torch.isfinite(p).all(dim=-1) & torch.isfinite(F)
    converged = done & finite & (nvalid >= 3)
    return GaussFit(ampl=p[..., 0], center=p[..., 1], dev=p[..., 2],
                    converged=converged, cost=F)
