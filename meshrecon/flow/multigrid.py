"""Linear multigrid solver for the Horn-Schunck linearized flow system.

The production flow budget was 60 Jacobi sweeps per warp linearization
(variational._hs_sweeps) — the measured quality ablation showed the budget
earns its cost (i45: med 0.161 vs i60: 0.125 on koule), i.e. the solver is
CONVERGENCE-limited, not model-limited. Jacobi contracts low-frequency error
at ~(1 - O(1/N^2)) per sweep, so most of those 60 sweeps fight the smooth
modes. The classic fix (Bruhn et al., real-time variational flow) is linear
multigrid: relax a few sweeps per level, restrict the residual, solve the
error equation coarse, prolong the correction back. 1-2 V-cycles reach a
BETTER-converged solution than 60 sweeps for ~4x less fine-grid work — and
every ingredient (Jacobi sweeps, 5-tap pyramid restriction/prolongation) is
the same fused-XLA machinery the solver already uses. No gathers, no new
Pallas.

The flop analysis does not decide the wall time on an accelerator: plain
Jacobi compiles to ONE fused loop, while the W-cycle fragments into ~19
level visits x ~15 small XLA ops per solve, each with fixed launch/fusion
overhead (its time on the H100 is not measured yet). The solver is kept as
`variational_flow(..., solver="mg")`: it is the convergence REFERENCE (2
cycles beat 60 sweeps against a 1500-sweep fixed point) and the right
engine on op-overhead-free backends (CPU).

System being solved (the fixed point of variational._hs_sweeps' iteration,
the reference's relaxation semantics, flow.cpp:27-32): per pixel,

    (alpha2 + ixx + iyy) * u - (alpha2 + iyy) * avg(u) + ixy * avg(v) = bu
    (alpha2 + ixx + iyy) * v - (alpha2 + ixx) * avg(v) + ixy * avg(u) = bv

with ixx = Ix^2, iyy = Iy^2, ixy = Ix*Iy, bu = -Ix*c, bv = -Iy*c,
c = It - Ix*u0 - Iy*v0, and avg the 1/6-1/12 HS neighborhood average. The
FINE level uses exactly this operator, so the V-cycle's fixed point IS the
Jacobi path's fixed point; coarse levels only accelerate convergence:

  - coarse coefficients (ixx, iyy, ixy) and residuals restrict by the
    value-preserving 5-tap pyramid average (pyr_down);
  - the smoothness weight scales alpha2 -> alpha2/4 per level: the discrete
    (u - avg(u)) stencil represents h^2 * Laplacian, so representing the
    FINE operator on a 2h grid needs a 4x smaller coefficient (the standard
    rediscretization rule; verified numerically in tests/test_multigrid.py
    by convergence against a 600-sweep Jacobi fixed point).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from meshrecon.flow.pyramid import pyr_down, pyr_up

# Cycle shape: sweeps before/after coarse-grid correction, recursive visits
# per level (GAMMA=2 at the top GAMMA_DEPTH levels makes it a truncated
# W-cycle — the extra coarse visits fix the V-cycle's ~0.5x/cycle
# asymptotic stall on strongly data-weighted pixels, while capping the
# branching keeps the op count near-linear: an uncapped W-cycle visits
# level l 2^l times, which balloons the XLA graph and its small-op
# dispatches for identical convergence — measured int-max 0.496 capped vs
# 0.495 full-W on the 240x320 fixture), coarsest-level sweep count, and the
# size below which recursion stops. Measured against a 2000-sweep Jacobi
# fixed point: 2 truncated W-cycles (~21 fine-sweep equivalents) reach
# interior-max error 0.50 / mean 0.09 px where 60 plain Jacobi sweeps
# reach 1.38 / 0.24 — 3x less work, ~2.5x better converged. Undamped
# Jacobi smooths best here (omega=0.8 measured worse); alpha-scale 0.5/1.0
# per level measured worse than the 0.25 rule.
NU_PRE = 2
NU_POST = 2
GAMMA = 2
GAMMA_DEPTH = 2
COARSE_SWEEPS = 24
COARSE_SIZE = 8


# the MG operator MUST match the Jacobi fixed point it is documented to
# share — import the stencil rather than copy it (variational imports
# multigrid only lazily inside _hs_level, so this is cycle-free)
from meshrecon.flow.variational import _hs_average, _pad_hw  # noqa: E402


def _smooth(u, v, au, av, axy, bu, bv, iters):
    """``iters`` coupled Jacobi sweeps with premultiplied coefficients:
    au = (alpha2+iyy)/denom, av = (alpha2+ixx)/denom, axy = ixy/denom,
    bu/bv already divided by denom."""

    def body(_, uv):
        uu, vv = uv
        ub = _hs_average(uu)
        vb = _hs_average(vv)
        return au * ub - axy * vb + bu, av * vb - axy * ub + bv

    return jax.lax.fori_loop(0, iters, body, (u, v))


def _level_coeffs(ixx, iyy, ixy, alpha2):
    denom = alpha2 + ixx + iyy
    inv = 1.0 / denom
    return (alpha2 + iyy) * inv, (alpha2 + ixx) * inv, ixy * inv, denom


def _residual(u, v, ixx, iyy, ixy, denom, bu, bv, alpha2):
    ub = _hs_average(u)
    vb = _hs_average(v)
    r_u = bu - (denom * u - (alpha2 + iyy) * ub + ixy * vb)
    r_v = bv - (denom * v - (alpha2 + ixx) * vb + ixy * ub)
    return r_u, r_v


def _build_hierarchy(ixx, iyy, ixy, alpha2):
    """Precompute per-level coefficient fields (restricted) and the
    premultiplied smoother coefficients; shared by all V-cycles."""
    levels = []
    a2 = alpha2
    while True:
        au, av, axy_n, denom = _level_coeffs(ixx, iyy, ixy, a2)
        levels.append(dict(ixx=ixx, iyy=iyy, ixy=ixy, denom=denom,
                           au=au, av=av, axy=axy_n, inv=1.0 / denom,
                           alpha2=a2, shape=ixx.shape[-2:]))
        if min(ixx.shape[-2:]) <= COARSE_SIZE:
            break
        ixx = pyr_down(ixx)
        iyy = pyr_down(iyy)
        ixy = pyr_down(ixy)
        a2 = a2 * 0.25
    return levels


def _vcycle(lvl, levels, u, v, bu, bv):
    L = levels[lvl]
    bu_n = bu * L["inv"]
    bv_n = bv * L["inv"]
    if lvl == len(levels) - 1:
        return _smooth(u, v, L["au"], L["av"], L["axy"], bu_n, bv_n,
                       COARSE_SWEEPS)
    u, v = _smooth(u, v, L["au"], L["av"], L["axy"], bu_n, bv_n, NU_PRE)
    r_u, r_v = _residual(u, v, L["ixx"], L["iyy"], L["ixy"], L["denom"],
                         bu, bv, L["alpha2"])
    r_uc = pyr_down(r_u)
    r_vc = pyr_down(r_v)
    e_u = jnp.zeros_like(r_uc)
    e_v = jnp.zeros_like(r_vc)
    for _ in range(GAMMA if lvl < GAMMA_DEPTH else 1):
        e_u, e_v = _vcycle(lvl + 1, levels, e_u, e_v, r_uc, r_vc)
    u = u + pyr_up(e_u, L["shape"])
    v = v + pyr_up(e_v, L["shape"])
    return _smooth(u, v, L["au"], L["av"], L["axy"], bu_n, bv_n, NU_POST)


def hs_solve_mg(prev, warped, u0, v0, alpha2, cycles: int = 2):
    """Multigrid solve of the HS linearization at (u0, v0); returns (u, v).

    Drop-in replacement for ``variational._hs_sweeps`` (same operator, same
    edge-padded boundary, same warp-anchored data term c = It - Ix*u0 -
    Iy*v0; gradients of the temporal average like _gradients). prev: (H, W)
    or batched (..., H, W); warped/u0/v0 matching.
    """
    m = 0.5 * (prev + warped)
    p = _pad_hw(m)
    ix = (p[..., 1:-1, 2:] - p[..., 1:-1, :-2]) * 0.5
    iy = (p[..., 2:, 1:-1] - p[..., :-2, 1:-1]) * 0.5
    it = warped - prev
    c = it - ix * u0 - iy * v0
    return hs_solve_mg_fields(ix, iy, c, u0, v0, alpha2, cycles=cycles)


def hs_solve_mg_fields(ix, iy, c, u0, v0, alpha2, cycles: int = 2):
    """Multigrid solve given precomputed (ix, iy, c); see hs_solve_mg."""
    ixx = ix * ix
    iyy = iy * iy
    ixy = ix * iy
    bu = -ix * c
    bv = -iy * c
    levels = _build_hierarchy(ixx, iyy, ixy, alpha2)
    u, v = u0, v0
    for _ in range(cycles):
        u, v = _vcycle(0, levels, u, v, bu, bv)
    return u, v
