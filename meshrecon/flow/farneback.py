"""Farneback-style dense optical flow via polynomial expansion.

The reference's `-f` path uses OpenCV's Farneback algorithm (flow.cpp:22-26:
levels=10, pyr_scale=0.8, winsize=(h+w)/100, iters=7, poly_n=5/7,
poly_sigma=(h+w)/1000). We implement the same method from its definition —
fit a local quadratic f(x) ~= c + b.x + x.A.x under a Gaussian applicability
window via separable moment filters, then solve for the displacement that
aligns the two quadratics — with a dyadic pyramid (XLA-friendly resampling)
instead of the reference's 0.8-scale pyramid; iteration counts are chosen to
give comparable effective depth. Every stage is separable correlations +
per-pixel 2x2 solves: pure fused elementwise work.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from meshrecon.flow.pyramid import pyr_down, pyr_up
from meshrecon.raster.fragment import bilinear_sample


def _poly_exp_setup(n: int, sigma: float):
    """Precompute separable moment kernels and the inverse Gram matrix.

    Basis ordering: [1, x, y, x^2, y^2, xy] over the (2n+1)^2 window with
    Gaussian weight w. Returns (offsets u, w, G_inv) as numpy arrays.
    """
    u = np.arange(-n, n + 1, dtype=np.float64)
    w = np.exp(-(u**2) / (2.0 * sigma * sigma))
    w /= w.sum()
    # separable basis moments: G[i, j] = sum w(x)w(y) B_i B_j
    # nonzero pattern mixes only {1, x^2, y^2}; x, y, xy are orthogonal
    W = np.outer(w, w)
    X, Y = np.meshgrid(u, u, indexing="xy")
    basis = [np.ones_like(X), X, Y, X * X, Y * Y, X * Y]
    G = np.zeros((6, 6))
    for i in range(6):
        for j in range(6):
            G[i, j] = np.sum(W * basis[i] * basis[j])
    G_inv = np.linalg.inv(G)
    return u, w, G_inv


def _sep_correlate(img, kx, ky):
    """Separable correlation with 1-D kernels kx (cols) and ky (rows)."""
    n = (len(kx) - 1) // 2
    p = jnp.pad(img, ((n, n), (n, n)), mode="reflect")
    h, w = img.shape
    acc = 0.0
    for i, kv in enumerate(ky):
        if kv == 0.0:
            continue
        acc = acc + kv * p[i : i + h, n : n + w]
    p2 = jnp.pad(acc, ((0, 0), (n, n)), mode="reflect")
    out = 0.0
    for j, kv in enumerate(kx):
        if kv == 0.0:
            continue
        out = out + kv * p2[:, j : j + w]
    return out


def _poly_expansion(img, u, w, g_inv):
    """Per-pixel quadratic coefficients (b1, b2, a11, a22, a12) of the image.

    Moments via separable correlations; coefficient mixing by the constant
    G^-1 (per Farneback's dual-basis formulation).
    """
    wu = w * u
    wu2 = w * u * u
    m = [
        _sep_correlate(img, w, w),  # 1
        _sep_correlate(img, wu, w),  # x
        _sep_correlate(img, w, wu),  # y
        _sep_correlate(img, wu2, w),  # x^2
        _sep_correlate(img, w, wu2),  # y^2
        _sep_correlate(img, wu, wu),  # xy
    ]
    m = jnp.stack(m, axis=-1)  # (H, W, 6)
    coef = jnp.einsum("ij,hwj->hwi", jnp.asarray(g_inv, jnp.float32), m,
                      precision=jax.lax.Precision.HIGHEST)
    # f = c + b.x + x.A.x with A=[[a11,a12],[a12,a22]]
    b1, b2 = coef[..., 1], coef[..., 2]
    a11, a22, a12 = coef[..., 3], coef[..., 4], coef[..., 5] * 0.5
    return b1, b2, a11, a22, a12


def _box(img, n):
    """(2n+1)^2 box average (the displacement-field smoothing window)."""
    k = np.ones(2 * n + 1) / (2 * n + 1)
    return _sep_correlate(img, k, k)


def _flow_level(f1, f2, flow, poly, win, iters):
    u, w, g_inv = poly
    b1a, b2a, a11a, a22a, a12a = _poly_expansion(f1, u, w, g_inv)
    b1b, b2b, a11b, a22b, a12b = _poly_expansion(f2, u, w, g_inv)
    h, wd = f1.shape
    cols = jnp.arange(wd, dtype=jnp.float32)[None, :]
    rows = jnp.arange(h, dtype=jnp.float32)[:, None]

    for _ in range(iters):
        dx, dy = flow[..., 0], flow[..., 1]
        sc, sr = cols + dx, rows + dy

        def samp(img):
            # true gather warp: the carried flow is full-magnitude at every
            # level (see variational.py note on shift-warp clamping)
            return bilinear_sample(img, sc, sr)

        # average the two quadratics, second one at the displaced position
        a11 = 0.5 * (a11a + samp(a11b))
        a22 = 0.5 * (a22a + samp(a22b))
        a12 = 0.5 * (a12a + samp(a12b))
        db1 = -0.5 * (samp(b1b) - b1a) + (a11 * dx + a12 * dy)
        db2 = -0.5 * (samp(b2b) - b2a) + (a12 * dx + a22 * dy)

        # normal equations G d = h smoothed over the window
        g11 = _box(a11 * a11 + a12 * a12, win)
        g12 = _box(a11 * a12 + a12 * a22, win)
        g22 = _box(a12 * a12 + a22 * a22, win)
        h1 = _box(a11 * db1 + a12 * db2, win)
        h2 = _box(a12 * db1 + a22 * db2, win)
        det = g11 * g22 - g12 * g12
        det = jnp.where(jnp.abs(det) < 1e-9, 1e-9, det)
        dx_new = (g22 * h1 - g12 * h2) / det
        dy_new = (g11 * h2 - g12 * h1) / det
        flow = jnp.stack([dx_new, dy_new], axis=-1)
    return flow


@functools.partial(
    jax.jit,
    # poly_sigma is static: it parameterizes the host-side numpy setup of
    # the polynomial-expansion basis (_poly_exp_setup), not device math
    static_argnames=("levels", "iters", "poly_n", "poly_sigma", "winsize",
                     "min_size"),
)
def farneback_flow(
    prev,
    next_,
    levels: int = 5,
    iters: int = 5,
    poly_n: int = 5,
    poly_sigma: float = 1.2,
    winsize: int = 15,
    min_size: int = 16,
):
    """Dense flow prev -> next by polynomial expansion. Returns (H, W, 2).

    winsize follows the OpenCV convention — the FULL width of the
    displacement-smoothing averaging window (cv::calcOpticalFlowFarneback's
    winsize; the reference passes (h+w)/100, flow.cpp:24-26). Round 2's
    parameter took the box HALF-width, so OpenCV-matched values smoothed
    over ~2x the intended support; matched-parameter
    remap errors are tabled in BASELINE.md.
    """
    f1 = jnp.asarray(prev, jnp.float32)
    f2 = jnp.asarray(next_, jnp.float32)
    win = max(int(winsize) // 2, 1)  # box half-width: kernel = 2*win+1 taps
    poly = _poly_exp_setup(poly_n, poly_sigma)

    pyr1, pyr2 = [f1], [f2]
    for _ in range(levels - 1):
        if min(pyr1[-1].shape) <= min_size:
            break
        pyr1.append(pyr_down(pyr1[-1]))
        pyr2.append(pyr_down(pyr2[-1]))

    flow = jnp.zeros(pyr1[-1].shape + (2,), jnp.float32)
    for lvl in range(len(pyr1) - 1, -1, -1):
        a, b = pyr1[lvl], pyr2[lvl]
        if flow.shape[:2] != a.shape:
            fx = pyr_up(flow[..., 0], a.shape) * 2.0
            fy = pyr_up(flow[..., 1], a.shape) * 2.0
            flow = jnp.stack([fx, fy], axis=-1)
        flow = _flow_level(a, b, flow, poly, win, iters)
    return flow
