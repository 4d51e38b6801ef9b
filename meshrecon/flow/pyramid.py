"""Gaussian image pyramids and the pyramid-summed L1 difference.

``compare`` is the flow-variance estimator of the reference (util.cpp:332-361):
the absolute difference between two images is computed at every pyramid level
and cascaded back to full resolution, so each pixel's value aggregates
mismatch at all scales. It feeds the covariance weighting of the depth
triangulation (util.cpp:222) and the flow's variance channel (flow.cpp:34).

All ops are 5-tap separable filters expressed as shifted adds — XLA fuses
these into a handful of elementwise passes; no convolution primitives
needed.
"""

from __future__ import annotations

import jax.numpy as jnp

# binomial 5-tap kernel, the classic pyramid filter
_K5 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _sep5(img, axis):
    pad = [(0, 0)] * img.ndim
    pad[axis] = (2, 2)
    p = jnp.pad(img, pad, mode="reflect")

    def sl(off):
        idx = [slice(None)] * img.ndim
        idx[axis] = slice(off, off + img.shape[axis])
        return p[tuple(idx)]

    return sum(w * sl(i) for i, w in enumerate(_K5))


def gauss5(img):
    """5x5 binomial blur with reflect-101 borders (last two axes; leading
    axes are batch)."""
    return _sep5(_sep5(img, -2), -1)


def pyr_down(img):
    """Blur + decimate by 2 (keeps even rows/cols; output ceil(n/2))."""
    return gauss5(img)[..., ::2, :][..., :, ::2]


def pyr_up(img, out_shape):
    """Zero-stuff upsample to `out_shape` then blur with the 2x-gain kernel.

    Zero-stuffing uses ``lax.pad`` INTERIOR padding — the strided-scatter
    form (``zeros.at[..., ::2, ::2].set(img)``) lowered to a real scatter
    and once dominated the whole flow solver; interior padding is a native
    XLA dilation.
    """
    import jax

    oh, ow = out_shape
    cfg = [(0, 0, 0)] * (img.ndim - 2) + [(0, 1, 1), (0, 1, 1)]
    up = jax.lax.pad(img, jnp.zeros((), img.dtype), cfg)
    up = up[..., :oh, :ow]
    return gauss5(up) * 4.0


def compare(prev, next_):
    """Pyramid-cascaded L1 difference (util.cpp:332-361).

    prev, next_: (H, W) float images. Returns (H, W) float32 aggregated
    absolute difference — the flow variance estimate.
    """
    # pyr_down is linear, so down(a) - down(b) == down(a - b): pyramid the
    # DIFFERENCE once instead of both images (halves the downward filtering;
    # the abs stays outside the filter exactly as in util.cpp:332-361)
    d = jnp.asarray(prev, jnp.float32) - jnp.asarray(next_, jnp.float32)
    diffs = []
    size = min(d.shape[-2], d.shape[-1])
    while True:
        diffs.append(jnp.abs(d))
        if size <= 2:
            break
        d = pyr_down(d)
        size //= 2
    acc = diffs[-1]
    for lvl in range(len(diffs) - 2, -1, -1):
        acc = diffs[lvl] + pyr_up(acc, diffs[lvl].shape[-2:])
    return acc
