"""Coarse-to-fine variational (Horn-Schunck) dense optical flow.

The reference's default flow algorithm is OpenCV's variational refinement
(flow.cpp:27-30), a Horn-Schunck-family energy minimized with relaxation
sweeps. Our scheme is the classic pyramidal HS:

  at each pyramid level (coarse -> fine):
    warp `next` by the upsampled flow estimate (bilinear)
    linearize: It = warped - prev, (Ix, Iy) from the warped/prev average
    run N weighted-Jacobi iterations of the HS update:
        ubar   = neighborhood average of u  (the HS Laplacian stencil)
        num    = Ix*ubar + Iy*vbar + It
        u      = ubar - Ix * num / (alpha^2 + Ix^2 + Iy^2)

Jacobi (not SOR) keeps every sweep fully data-parallel; each sweep is one
fused elementwise pass of shifted adds — no gathers, no dynamic shapes. The
warps are plain XLA gathers (bilinear_warp).
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp

from meshrecon.flow.pyramid import pyr_down, pyr_up
from meshrecon.flow.remap import bilinear_warp


# Sweep-count override for A/Bs (0 = per-solver default: 14 accelerated
# Chebyshev sweeps / 60 plain Jacobi). The sweeps are the
# compute-bound core of the flow solve; fewer sweeps trade fixed-point
# residual for wall time, and the e2e quality cost must be measured, not
# assumed (tools/iters_study.py).
_FLOW_ITERS = int(os.environ.get("MESHRECON_FLOW_ITERS", "0"))

# Warp-iteration override for the FINEST pyramid level only (0 = keep the
# global ``warps`` default, 2). The finest level's warp+solve pair is the
# single most expensive flow stage (warp + sweeps at the full stack); the
# coarser levels' second warp is nearly free and seeds the
# fine initialization, so the cut applies only where it pays.
_FLOW_FINE_WARPS = int(os.environ.get("MESHRECON_FLOW_FINE_WARPS", "0"))

# Coarse-level warp-count override (0 = the caller's ``warps`` default,
# 2). Each warp at a NON-finest level re-linearizes the data term around
# the relaxed flow (warp + gradients + a full sweep block); the pipeline's
# flows run against rendered predictions whose per-level residuals are
# already sub-pixel after the upsampled initialization, so the second
# coarse warp mostly re-solves a settled system — the finest level has
# run 1 warp since round 4 (_FLOW_FINE_WARPS) for exactly this reason.
# Gate any default flip on the full-res study like the lv3 flip was.
_FLOW_WARPS = int(os.environ.get("MESHRECON_FLOW_WARPS", "0"))

# Pyramid-depth override (0 = the caller's ``levels`` default — 3 for
# the pipeline since round 4, 6 for the public flow API). The
# pyramid exists to capture LARGE displacements; in the production
# pipeline every variational solve runs against the RENDERED PREDICTION
# of the main frame (recon.cpp:82-101 analog), whose residual flow is a
# few pixels — the deep levels re-derive a near-zero coarse field.
# Quality-neutral at full res standalone AND under the quality preset
# (BASELINE.md).
_FLOW_LEVELS = int(os.environ.get("MESHRECON_FLOW_LEVELS", "0"))

# import-time values = the process defaults a zero config knob restores
# (config.apply_kernel_knobs) — otherwise one study config's override
# would leak into the next config's run
_DEFAULTS = (_FLOW_ITERS, _FLOW_FINE_WARPS, _FLOW_LEVELS, _FLOW_WARPS)


def set_flow_knobs(iters: int | None = None, fine_warps: int | None = None,
                   levels: int | None = None, warps: int | None = None):
    """Set the flow-solver knobs mid-process (config/CLI plumbing); clears
    jit caches so traces that baked the old values cannot go stale."""
    global _FLOW_ITERS, _FLOW_FINE_WARPS, _FLOW_LEVELS, _FLOW_WARPS
    changed = False
    if warps is not None and int(warps) != _FLOW_WARPS:
        if warps < 0:
            raise ValueError(
                f"flow warps must be >= 0 (0 = caller default): {warps}")
        _FLOW_WARPS = int(warps)
        changed = True
    if levels is not None and int(levels) != _FLOW_LEVELS:
        if levels < 0:
            raise ValueError(
                f"flow levels must be >= 0 (0 = caller default): {levels}")
        _FLOW_LEVELS = int(levels)
        changed = True
    if iters is not None and int(iters) != _FLOW_ITERS:
        if iters < 0:
            raise ValueError(f"flow iters must be >= 0 (0 = auto): {iters}")
        _FLOW_ITERS = int(iters)
        changed = True
    if fine_warps is not None and int(fine_warps) != _FLOW_FINE_WARPS:
        if fine_warps < 0:
            raise ValueError(
                f"fine warps must be >= 0 (0 = global default): {fine_warps}")
        _FLOW_FINE_WARPS = int(fine_warps)
        changed = True
    if changed:
        jax.clear_caches()


def _pad_hw(u):
    pad = [(0, 0)] * (u.ndim - 2) + [(1, 1), (1, 1)]
    return jnp.pad(u, pad, mode="edge")


def _hs_average(u):
    """Horn-Schunck neighborhood average: 4-neighbors 1/6, diagonals 1/12.
    Operates on the last two axes; leading axes are batch."""
    p = _pad_hw(u)
    s4 = (p[..., :-2, 1:-1] + p[..., 2:, 1:-1]
          + p[..., 1:-1, :-2] + p[..., 1:-1, 2:])
    s8 = (p[..., :-2, :-2] + p[..., :-2, 2:]
          + p[..., 2:, :-2] + p[..., 2:, 2:])
    return s4 / 6.0 + s8 / 12.0


def _gradients(a, b):
    """Spatial gradients of the temporal average (central differences)."""
    m = 0.5 * (a + b)
    p = _pad_hw(m)
    ix = (p[..., 1:-1, 2:] - p[..., 1:-1, :-2]) * 0.5
    iy = (p[..., 2:, 1:-1] - p[..., :-2, 1:-1]) * 0.5
    return ix, iy


def _hs_sweeps(prev, warped, u0, v0, alpha2, iters):
    """Jacobi relaxation given the warped image (linearized at (u0, v0))."""
    ix, iy = _gradients(prev, warped)
    it = warped - prev
    denom = alpha2 + ix * ix + iy * iy

    def body(_, uv):
        u, v = uv
        ub = _hs_average(u)
        vb = _hs_average(v)
        num = (ix * (ub - u0) + iy * (vb - v0) + it) / denom
        return ub - ix * num, vb - iy * num

    return jax.lax.fori_loop(0, iters, body, (u0, v0))


def cheb_coeffs(iters: int, rho: float):
    """Chebyshev semi-iteration coefficients (a_k, b_k) for iters steps.

    For the affine fixed-point iteration x <- G x + c with the spectrum of
    G real and contained in [-rho, 1], the accelerated iterates
        x_{k+1} = a_k (G x_k + c) + b_k x_{k-1},  a_k + b_k = 1
    carry the error polynomial T_k(lam/rho)/T_k(1/rho): every mode with
    |lam| <= rho is damped at the asymptotic rate rho/(1+sqrt(1-rho^2))
    per step instead of Jacobi's |lam| — ~3x fewer sweeps at equal
    residual for the HS stencil, whose spectrum is [-1/3, 1) (checkerboard
    mode -1/3; smooth modes -> 1). Modes in (rho, 1] are damped no slower
    than plain Jacobi (the ratio T_k(lam/rho)/T_k(1/rho) < 1), so a
    spectrum edge touching 1 — zero-gradient pixels — cannot diverge.
    """
    mus = [1.0, 1.0 / rho]
    ab = [(1.0, 0.0)]
    for k in range(1, iters):
        mu_next = 2.0 / rho * mus[k] - mus[k - 1]
        ab.append((2.0 * mus[k] / (rho * mu_next), -mus[k - 1] / mu_next))
        mus.append(mu_next)
    return ab


def _hs_sweeps_cheb(prev, warped, u0, v0, alpha2, iters, rho: float = 0.98):
    """Chebyshev-accelerated Jacobi relaxation; same fixed point as
    _hs_sweeps (the acceleration only reweights the iterate history, the
    converged solution is identical). Measured on the 64x80 fixture:
    cheb20 rho=0.98 reaches 4x lower fixed-point error than jacobi60
    (mean 0.071 vs 0.295 px) at 1/3 the sweeps; per-sweep extra cost is
    one axpy per field. rho trades bulk damping (1/T_k(1/rho), stronger
    for smaller rho) against the width of the damped band; 0.98 won the
    sweep over {0.85..0.999} at every iters in {16..40}."""
    ix, iy = _gradients(prev, warped)
    it = warped - prev
    denom = alpha2 + ix * ix + iy * iy

    def jac(u, v):
        ub = _hs_average(u)
        vb = _hs_average(v)
        num = (ix * (ub - u0) + iy * (vb - v0) + it) / denom
        return ub - ix * num, vb - iy * num

    coeffs = jnp.asarray(cheb_coeffs(iters, rho), jnp.float32)

    def body(state, ab_k):
        u, v, up, vp = state
        a_k, b_k = ab_k[0], ab_k[1]
        yu, yv = jac(u, v)
        un = a_k * yu + b_k * up
        vn = a_k * yv + b_k * vp
        return (un, vn, u, v), None

    (u, v, _, _), _ = jax.lax.scan(body, (u0, v0, u0, v0), coeffs)
    return u, v


def _hs_level(prev, next_, u0, v0, alpha2, iters, solver: str = "jacobi",
              cycles: int = 2):
    """One warp iteration: linearize around (u0, v0) and relax the total flow.

    Data term: Ix*(u - u0) + Iy*(v - v0) + It = 0 with It evaluated at the
    warp point — omitting the -u0 anchoring is the classic pyramidal-HS bug.

    The warp is a true gather, so it handles UNBOUNDED total flow (a clamped
    shift-warp here once corrupted a 20 px translation into 36 px).
    """
    if next_.ndim >= 3:
        h, w = next_.shape[-2:]
        uv = jnp.stack([u0, v0], axis=-1)
        warped = jax.vmap(bilinear_warp)(
            next_.reshape(-1, h, w), uv.reshape(-1, h, w, 2)
        ).reshape(next_.shape)
    else:
        warped = bilinear_warp(next_, jnp.stack([u0, v0], axis=-1))
    if solver == "mg":
        from meshrecon.flow.multigrid import hs_solve_mg

        u, v = hs_solve_mg(prev, warped, u0, v0, alpha2, cycles=cycles)
    elif solver == "cheb":
        u, v = _hs_sweeps_cheb(prev, warped, u0, v0, alpha2, iters)
    else:
        u, v = _hs_sweeps(prev, warped, u0, v0, alpha2, iters)
    return u, v, warped


# NOTE: a residual re-warp against the already-warped image (shift-
# decomposed, bounded) was attempted to avoid the second gather per level;
# it degraded flow quality in tests — per-level residuals after a full
# relaxation pass are not reliably small.


@functools.partial(
    jax.jit,
    static_argnames=("levels", "iters", "warps", "alpha", "min_size",
                     "solver", "cycles", "want_residual"),
)
def variational_flow(
    prev,
    next_,
    levels: int = 6,
    iters: int | None = None,
    warps: int = 2,
    alpha: float = 12.0,
    min_size: int = 12,
    solver: str = "cheb",
    cycles: int = 2,
    want_residual: bool = False,
):
    """Dense flow prev -> next: next(x + flow(x)) ~= prev(x).

    prev: (H, W) grayscale float (0..255 scale); next_: (H, W) or a BATCH
    (K, H, W) of targets sharing the same source. Returns (H, W, 2) (or
    (K, H, W, 2)) float32 (fx, fy) in pixels, the same convention as the
    reference's cv::DenseOpticalFlow::calc output (flow.cpp:31-32).

    The batched form solves all K flows in ONE program: relaxation sweeps
    and pyramid ops are elementwise (K just widens them), and each warp is
    one gather over the whole stack.

    want_residual: additionally return the FIRST-ORDER re-warped image
    ``warped + Ix*(u - u0) + Iy*(v - v0)`` — ``next_`` warped by the final
    flow, evaluated through the solver's own linearization around the last
    warp point instead of a fresh bicubic gather pass. Its difference from
    ``prev`` is exactly the converged data-term residual of the HS energy,
    i.e. the photometric error the variance channel estimates
    (util.cpp:332-361 feeds compare() with the true re-warp; the Taylor
    form replaces a bicubic gather pass with fused elementwise FMAs — see
    pipeline/fused.py variance="taylor"). The expansion is exact to
    first order in the final solve's increment, which is sub-pixel by
    construction after the pyramid initialization; where it is NOT small
    the extrapolated error is LARGE, which only strengthens the
    down-weighting that the variance exists to provide.

    levels: pyramid depth cap (also bounded by ``min_size``); the
    process-wide knob ``set_flow_knobs(levels=...)`` / MESHRECON_FLOW_LEVELS
    overrides a non-zero value here when set (0 = keep the caller's value).
    The PUBLIC defaults stay 6 levels / 2 warps (deep pyramid, full
    large-displacement recovery — round-4 advisor: library callers must
    not silently lose it). The PIPELINE call sites (pipeline/fused.py,
    flow/api.py) pass levels=2, warps=1 explicitly: their flows run
    against RENDERED predictions with few-pixel residuals, so deeper
    levels and coarse re-linearization passes only re-derive a
    near-settled field. The quality gates (levels 6 -> 3 -> 2, warps
    2 -> 1) measured a LOWER photometric self-check diff_sum and e2e
    quality within draw noise at 1/8 and full res — BASELINE.md "lv2
    flow-pyramid gate". ``--flow-levels 3 --flow-warps 2`` restores the
    older config.

    solver: "cheb" (default, the production fast path) runs
    Chebyshev-accelerated sweeps; "jacobi" runs ``iters`` plain fused
    relaxation sweeps per warp — a single fori_loop, same fixed point at
    ~3x the sweep count. "mg" runs ``cycles`` multigrid W-cycles
    (flow/multigrid.py): 3x less arithmetic and better converged, but its
    coarse-level visits fragment into hundreds of small XLA ops — an
    option and a reference solver, not the default.
    """
    if iters is None:
        # Chebyshev damps every mode below rho at ~rho/(1+sqrt(1-rho^2))
        # per sweep; accelerated sweeps out-converge 60 plain Jacobi
        # (test_flow.py::test_cheb_outconverges_jacobi) at ~1/3 the
        # arithmetic. 14 sweeps (was 20): quality-neutral on every seed at
        # 1/8 res (worst-seed med 0.0345 -> 0.0347, BASELINE.md round-4
        # table). MESHRECON_FLOW_ITERS / --flow-iters 20 restores.
        iters = _FLOW_ITERS or (14 if solver == "cheb" else 60)
    levels = _FLOW_LEVELS or levels
    warps = _FLOW_WARPS or warps
    prev = jnp.asarray(prev, jnp.float32)
    next_ = jnp.asarray(next_, jnp.float32)
    alpha2 = float(alpha * alpha)

    pyr_a = [prev]
    pyr_b = [next_]
    for _ in range(levels - 1):
        if min(pyr_a[-1].shape[-2:]) <= min_size:
            break
        pyr_a.append(pyr_down(pyr_a[-1]))
        pyr_b.append(pyr_down(pyr_b[-1]))

    u = jnp.zeros_like(pyr_b[-1])
    v = jnp.zeros_like(pyr_b[-1])
    for lvl in range(len(pyr_a) - 1, -1, -1):
        a, b = pyr_a[lvl], pyr_b[lvl]
        if u.shape[-2:] != a.shape[-2:]:
            # pyr_up preserves magnitude; flow VALUES double at 2x resolution
            u = pyr_up(u, a.shape[-2:]) * 2.0
            v = pyr_up(v, a.shape[-2:]) * 2.0
        # One warp at the finest level (coarser levels keep ``warps``): the
        # full-res displacement is already pyramid-initialized to sub-pixel
        # scale, so the second finest-level warp re-solves an almost-settled
        # system — dropping it is quality-neutral at 1/8 res on every seed
        # (trim2fw1 worst-seed med 0.0336 vs 0.0345) and saves one
        # full-stack warp + sweep block. --flow-fine-warps 2 restores.
        n_warps = (_FLOW_FINE_WARPS or 1) if lvl == 0 else warps
        for _ in range(n_warps):
            u_lin, v_lin = u, v  # linearization point of this warp
            u, v, warped = _hs_level(a, b, u, v, alpha2, iters,
                                     solver=solver, cycles=cycles)
    flow = jnp.stack([u, v], axis=-1)
    if not want_residual:
        return flow
    # first-order re-warp through the final level's own linearization:
    # warped is next_ gathered at (u_lin, v_lin); the solve moved the flow
    # by a sub-pixel increment, so the gradient extrapolation matches a
    # true re-gather to first order (and _gradients is the same symmetric
    # stencil the relaxation itself linearized with)
    ix, iy = _gradients(pyr_a[0], warped)
    rewarped = warped + ix * (u - u_lin) + iy * (v - v_lin)
    return flow, rewarped
