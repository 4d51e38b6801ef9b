"""Gather-free image warping by shift decomposition.

Warping an image by a flow field with bounded magnitude can be written,
without any data-dependent gather, as a weighted sum of SHIFTED copies of
the image:

    warp(img, f)[p] = sum_{d in window} img[p + d] * k(f(p) - d)

where k is the interpolation kernel (bilinear hat or Keys bicubic). Every
term is a dynamic-slice of a padded image + fused multiply-add (no
data-dependent addressing); for |f| <= R the result is EXACT (identical
to gather-based interpolation). Flows are clamped to [-R, R] first — inside
the pipeline, flow magnitudes between a real frame and its rendered
prediction are small by construction, and the pyramid levels of the flow
solver bound per-level displacements.

The double loop over window offsets runs as ``lax.fori_loop`` so trace and
compile sizes stay O(1) in the radius.

APPLICABILITY: only where displacements are BOUNDED BY CONSTRUCTION (the
clamp silently corrupts larger flows — a 20 px translation came back as
36 px when these warps backed the pyramid solver, whose per-level warp
carries FULL-magnitude flow). Correct uses: residual warps inside a single
solver level and small-displacement contexts.
The production flow solvers use true gather warps.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _warp_loop(img, fx, fy, radius: int, taps: int, kernel):
    """Shared shift-decomposition loop.

    taps: kernel support per axis (2 for bilinear, 4 for bicubic); window
    offsets run over [-radius - taps//2 + 1, radius + taps//2].
    """
    img = jnp.asarray(img, jnp.float32)
    h, w = img.shape
    fx = jnp.clip(fx, -radius, radius)
    fy = jnp.clip(fy, -radius, radius)
    lo = -radius - (taps // 2 - 1)
    hi = radius + taps // 2
    n = hi - lo + 1
    pad = max(-lo, hi)
    p = jnp.pad(img, pad, mode="edge")

    def body(i, out):
        dy = lo + i // n
        dx = lo + i % n
        shifted = jax.lax.dynamic_slice(p, (pad + dy, pad + dx), (h, w))
        wgt = kernel(fy - dy.astype(jnp.float32)) * kernel(
            fx - dx.astype(jnp.float32)
        )
        return out + shifted * wgt

    return jax.lax.fori_loop(0, n * n, body, jnp.zeros_like(img))


def _hat(t):
    return jnp.maximum(1.0 - jnp.abs(t), 0.0)


def _cubic_kernel(t, a=-0.75):
    """Keys bicubic kernel (OpenCV's a=-0.75), evaluated at |t|."""
    at = jnp.abs(t)
    at2 = at * at
    at3 = at2 * at
    w1 = (a + 2.0) * at3 - (a + 3.0) * at2 + 1.0  # |t| <= 1
    w2 = a * at3 - 5.0 * a * at2 + 8.0 * a * at - 4.0 * a  # 1 < |t| < 2
    return jnp.where(at <= 1.0, w1, jnp.where(at < 2.0, w2, 0.0))


@functools.partial(jax.jit, static_argnames=("radius",))
def shift_warp_bilinear(img, fx, fy, radius: int = 6):
    """out[p] = bilinear img sample at p + (fx, fy); exact for |f| <= radius."""
    return _warp_loop(img, fx, fy, radius, 2, _hat)


@functools.partial(jax.jit, static_argnames=("radius",))
def shift_warp_bicubic(img, fx, fy, radius: int = 6):
    """Bicubic (Catmull-Rom a=-0.75) warp; exact for |f| <= radius."""
    return _warp_loop(img, fx, fy, radius, 4, _cubic_kernel)
