"""The XLA gather samplers against float64 NumPy references.

bilinear_sample (projection, plane sweep), bilinear_warp (the flow
solver's warps), flow_remap (bicubic variance re-warp) and nearest_sample
(the shadow test) carry the semantics the pipeline relies on: unbounded
displacements, border clamping, batching without bleed between images,
and GL_NEAREST's round-half-up.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from meshrecon.flow.remap import bilinear_warp, flow_remap
from meshrecon.raster.fragment import bilinear_sample, nearest_sample

_ATOL = 1e-3  # float32 weights on 0..255 intensities


def _ref_bilinear(img, col, row):
    img = np.asarray(img, np.float64)
    h, w = img.shape
    col = np.clip(np.asarray(col, np.float64), 0, w - 1)
    row = np.clip(np.asarray(row, np.float64), 0, h - 1)
    c0 = np.floor(col).astype(int)
    r0 = np.floor(row).astype(int)
    c1 = np.minimum(c0 + 1, w - 1)
    r1 = np.minimum(r0 + 1, h - 1)
    fc, fr = col - c0, row - r0
    return (img[r0, c0] * (1 - fr) * (1 - fc) + img[r0, c1] * (1 - fr) * fc
            + img[r1, c0] * fr * (1 - fc) + img[r1, c1] * fr * fc)


def _ref_bicubic(img, col, row, a=-0.75):
    """OpenCV CV_INTER_CUBIC with each tap index clamped to the image."""
    img = np.asarray(img, np.float64)
    h, w = img.shape
    col = np.asarray(col, np.float64)
    row = np.asarray(row, np.float64)
    c0 = np.floor(col).astype(int)
    r0 = np.floor(row).astype(int)

    def weights(t):
        return [a * (t ** 3 - 2 * t ** 2 + t),
                (a + 2) * t ** 3 - (a + 3) * t ** 2 + 1,
                -(a + 2) * t ** 3 + (2 * a + 3) * t ** 2 - a * t,
                a * (t ** 2 - t ** 3)]

    wc, wr = weights(col - c0), weights(row - r0)
    out = np.zeros_like(col)
    for i in range(4):
        ri = np.clip(r0 + i - 1, 0, h - 1)
        for j in range(4):
            cj = np.clip(c0 + j - 1, 0, w - 1)
            out += wr[i] * wc[j] * img[ri, cj]
    return out


def _grid(h, w):
    c, r = np.meshgrid(np.arange(w, dtype=np.float32),
                       np.arange(h, dtype=np.float32))
    return c, r


@pytest.fixture
def img(rng):
    return rng.uniform(0, 255, size=(96, 160)).astype(np.float32)


def _bilinear(img, col, row):
    return np.asarray(bilinear_sample(jnp.asarray(img), jnp.asarray(col),
                                      jnp.asarray(row)))


def test_identity_is_exact(img):
    c, r = _grid(*img.shape)
    np.testing.assert_array_equal(_bilinear(img, c, r), img)


def test_large_translation(img):
    """A displacement far beyond any tile or neighbourhood is an exact
    gather: the sampler has no displacement budget."""
    c, r = _grid(*img.shape)
    col, row = c + 37.3, r - 21.7
    np.testing.assert_allclose(_bilinear(img, col, row),
                               _ref_bilinear(img, col, row), atol=_ATOL)


def test_border_clamp(img):
    """Coordinates past every border read the clamped border pixels."""
    c, r = _grid(*img.shape)
    col, row = c * 1.3 - 40.0, r * 1.5 - 30.0
    out = _bilinear(img, col, row)
    np.testing.assert_allclose(out, _ref_bilinear(img, col, row), atol=_ATOL)
    np.testing.assert_allclose(out[0, 0], img[0, 0], atol=_ATOL)
    np.testing.assert_allclose(out[-1, -1], img[-1, -1], atol=_ATOL)


def test_nonaligned_shape(rng):
    img = rng.uniform(0, 255, size=(45, 77)).astype(np.float32)
    c, r = _grid(45, 77)
    col = c + 2.3 + 3.0 * np.sin(r / 7.0)
    row = r + 1.1 + 2.0 * np.cos(c / 11.0)
    np.testing.assert_allclose(_bilinear(img, col, row),
                               _ref_bilinear(img, col, row), atol=_ATOL)


def test_flow_warp_matches_reference(img, rng):
    """bilinear_warp(image, flow) samples at (x + fx, y + fy)."""
    h, w = img.shape
    flow = rng.normal(scale=3.0, size=(h, w, 2)).astype(np.float32)
    flow[..., 0] += 6.0
    c, r = _grid(h, w)
    out = np.asarray(bilinear_warp(jnp.asarray(img), jnp.asarray(flow)))
    np.testing.assert_allclose(
        out, _ref_bilinear(img, c + flow[..., 0], r + flow[..., 1]),
        atol=_ATOL)


def test_bicubic_remap_matches_reference(img):
    """flow_remap is CV_INTER_CUBIC with clamped taps, borders included."""
    h, w = img.shape
    c, r = _grid(h, w)
    fx = 11.3 + 2.0 * np.sin(r / 37.0)
    fy = -6.7 + 1.5 * np.cos(c / 53.0)
    flow = np.stack([fx, fy], axis=-1).astype(np.float32)
    out = np.asarray(flow_remap(jnp.asarray(flow), jnp.asarray(img)))
    np.testing.assert_allclose(out, _ref_bicubic(img, c + fx, r + fy),
                               atol=5e-3)


def test_batched_warp_does_not_bleed(rng):
    """The batched warp (one gather over a stack) reads only its own image,
    even where the flow points far outside it."""
    h, w = 40, 56
    imgs = np.stack([rng.uniform(100 * k, 100 * k + 50, size=(h, w))
                     for k in range(3)]).astype(np.float32)
    flows = rng.normal(scale=2.0, size=(3, h, w, 2)).astype(np.float32)
    flows[1, ..., 1] += 3 * h  # far below the image
    flows[2, ..., 1] -= 3 * h  # far above it
    out = np.asarray(jax.vmap(bilinear_warp)(jnp.asarray(imgs),
                                             jnp.asarray(flows)))
    c, r = _grid(h, w)
    for k in range(3):
        assert out[k].min() >= 100 * k - _ATOL
        assert out[k].max() <= 100 * k + 50 + _ATOL
        np.testing.assert_allclose(
            out[k], _ref_bilinear(imgs[k], c + flows[k, ..., 0],
                                  r + flows[k, ..., 1]), atol=_ATOL)


def test_nearest_rounds_half_up(rng):
    """GL_NEAREST: floor(x + 0.5), so every .5 tie goes up (banker's
    rounding would send 0.5 and 2.5 down), clamped at the borders."""
    img = rng.uniform(0, 255, size=(6, 8)).astype(np.float32)
    col = np.asarray([0.5, 1.5, 2.5, 3.49, -0.7, 7.5, 9.0], np.float32)
    row = np.asarray([0.5, 2.5, 1.5, 4.5, 0.0, 5.5, -2.0], np.float32)
    got = np.asarray(nearest_sample(jnp.asarray(img), jnp.asarray(col),
                                    jnp.asarray(row)))
    ci = np.clip(np.floor(col.astype(np.float64) + 0.5).astype(int), 0, 7)
    ri = np.clip(np.floor(row.astype(np.float64) + 0.5).astype(int), 0, 5)
    np.testing.assert_array_equal(got, img[ri, ci])
    assert ci[:3].tolist() == [1, 2, 3] and ri[:3].tolist() == [1, 3, 2]
