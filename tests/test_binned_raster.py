"""The binned Triton raster kernel (raster/binned.py), run in the Pallas
interpreter, against render_depth and the float64 reference rasterizer;
plus the engine choice and the soup capacity rule around it.

On the card the same comparison runs compiled (tests marked ``gpu`` here,
and chip_smoke.py's kernel phase).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import __graft_entry__ as g
from meshrecon import BACKGROUND_DEPTH
from meshrecon.raster import rasterizer as R
from meshrecon.raster.binned import CHUNK, GROUP, render_depth_binned
from meshrecon.raster.reference import render_depth_reference
from meshrecon.raster.rasterizer import morton_order, render_depth

# interpret mode and render_depth agree to float32 rounding of the same
# affine coefficients; no pixel may change coverage
_ATOL = 1e-5


def _pad(soup, cap):
    t = len(soup)
    out = np.zeros((cap, 3, 3), np.float32)
    out[:t] = soup
    valid = np.zeros(cap, bool)
    valid[:t] = True
    return out, valid


def _sphere(cap=1024):
    soup = g._sphere_soup(n_theta=16, n_phi=16)  # 512 triangles
    soup = soup[morton_order(soup)]
    return _pad(soup, max(cap, len(soup)))


def _binned(cams, soup, valid, h, w):
    return np.asarray(render_depth_binned(
        np.asarray(cams, np.float32).reshape(-1, 4, 4), soup, valid, h, w,
        interpret=True))


def _xla(cam, soup, valid, h, w):
    return np.asarray(render_depth(cam, soup, valid, h, w))


@pytest.mark.parametrize("eye", [(0.3, 0.2, 0.5), (0.0, 0.0, 0.0),
                                 (-0.4, 0.3, 1.5)])
def test_matches_render_depth(eye):
    soup, valid = _sphere()
    cam = g._make_camera(eye=eye)
    h, w = 48, 64
    out = _binned(cam, soup, valid, h, w)[0]
    ref = _xla(cam, soup, valid, h, w)
    assert (ref < 1.0).mean() > 0.1  # the sphere is on screen
    np.testing.assert_allclose(out, ref, rtol=0, atol=_ATOL)


def test_matches_float64_reference(rng):
    cam = g._make_camera(eye=(0, 0, 6), near=0.5, far=50.0)
    soup = (rng.normal(size=(15, 3, 3)) * 1.0).astype(np.float32)
    soup, valid = _pad(soup, 256)
    out = _binned(cam, soup, valid, 48, 64)[0]
    ref = render_depth_reference(cam, soup[:15], 48, 64)
    assert np.mean((out < 1.0) != (ref < 1.0)) < 0.01
    both = (out < 1.0) & (ref < 1.0)
    # f32 edge functions vs the f64 reference, far under the 0.01 NDC
    # shadow bias (same bound as render_depth's own reference test)
    np.testing.assert_allclose(out[both], ref[both], atol=5e-3)


def test_empty_soup_is_background():
    soup = np.zeros((256, 3, 3), np.float32)
    valid = np.zeros(256, bool)
    out = _binned(g._make_camera(), soup, valid, 32, 48)
    np.testing.assert_array_equal(out, np.full((1, 32, 48), BACKGROUND_DEPTH,
                                               np.float32))


def test_shared_edge_ties_not_holed():
    """A quad split on its diagonal: sample points exactly on the shared
    edge must be covered (the tie slop of edge_affine_planes), exactly as
    render_depth covers them."""
    e = 4.0
    quad = np.asarray([[[-e, -e, 0.0], [e, -e, 0.0], [e, e, 0.0]],
                       [[-e, -e, 0.0], [e, e, 0.0], [-e, e, 0.0]]],
                      np.float32)
    soup, valid = _pad(quad, 256)
    cam = g._make_camera(fov=1.1, near=1.0, far=40.0, eye=(0, 0, 16))
    h, w = 48, 64
    out = _binned(cam, soup, valid, h, w)[0]
    np.testing.assert_allclose(out, _xla(cam, soup, valid, h, w), rtol=0,
                               atol=_ATOL)
    v = out != BACKGROUND_DEPTH
    rs, cs = np.where(v)
    interior = np.zeros_like(v)
    interior[rs.min() + 1:rs.max(), cs.min() + 1:cs.max()] = True
    assert not (interior & ~v).any()


def test_near_plane_clipping(rng):
    """Camera inside a triangle cloud: many triangles straddle w = 0 and
    clip to one or two screen triangles with far-flung vertices."""
    cam = g._make_camera(eye=(0, 0, 0.2), near=0.01, far=10.0)
    tris = rng.normal(size=(25, 3, 3)).astype(np.float32)
    soup, valid = _pad(tris, 256)
    h, w = 32, 48
    out = _binned(cam, soup, valid, h, w)[0]
    np.testing.assert_allclose(out, _xla(cam, soup, valid, h, w), rtol=0,
                               atol=_ATOL)
    ref = render_depth_reference(cam, tris, h, w)
    assert np.mean((out < 1.0) != (ref < 1.0)) < 0.02


def test_multi_chunk_multi_group():
    """More triangles than one group: the walk must visit every group and
    every chunk in it (a dropped trailing group would leave holes)."""
    soup, valid = _sphere(cap=4096)
    assert valid.sum() > 2 * CHUNK * GROUP
    cam = g._make_camera(eye=(0.1, -0.1, 0.2))
    h, w = 40, 56  # not a multiple of the 16 x 16 tile
    out = _binned(cam, soup, valid, h, w)[0]
    np.testing.assert_allclose(out, _xla(cam, soup, valid, h, w), rtol=0,
                               atol=_ATOL)


def test_multi_camera_grid():
    """All cameras of a dispatch share one grid axis: each camera's output
    must come from its own triangle planes."""
    soup, valid = _sphere()
    eyes = [(0.3, 0.2, 0.5), (0.0, 0.0, 0.0), (-0.2, 0.1, 0.3),
            (0.1, 0.4, -0.2)]
    cams = np.stack([g._make_camera(eye=e) for e in eyes])
    h, w = 32, 48
    out = _binned(cams, soup, valid, h, w)
    for i, cam in enumerate(cams):
        np.testing.assert_allclose(out[i], _xla(cam, soup, valid, h, w),
                                   rtol=0, atol=_ATOL)


def test_capacity_padding_invisible():
    """The same mesh at two capacities renders the same depths: padded
    triangles are invalid and their chunks are skipped."""
    soup, valid = _sphere(cap=1024)
    big, big_valid = _pad(soup[valid], 4096)
    cam = g._make_camera(eye=(0.3, 0.2, 0.5))
    np.testing.assert_array_equal(_binned(cam, soup, valid, 32, 48),
                                  _binned(cam, big, big_valid, 32, 48))


def test_morton_order_invariance():
    """Sorting only changes which triangles share a chunk, never a depth."""
    raw = g._sphere_soup(n_theta=16, n_phi=16)
    soup_raw, valid = _pad(raw, 1024)
    soup_sorted, _ = _pad(raw[morton_order(raw)], 1024)
    cam = g._make_camera(eye=(0.3, 0.2, 0.5))
    np.testing.assert_allclose(_binned(cam, soup_raw, valid, 32, 48),
                               _binned(cam, soup_sorted, valid, 32, 48),
                               rtol=0, atol=_ATOL)


def test_morton_order_is_a_permutation(rng):
    soup = rng.normal(size=(300, 3, 3)).astype(np.float32)
    order = morton_order(soup)
    np.testing.assert_array_equal(np.sort(order), np.arange(300))


def test_raster_engine_follows_backend(monkeypatch):
    assert R.raster_engine() == "xla"  # the tests run on the CPU
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert R.raster_engine() == "triton"


def test_render_depths_dispatch(monkeypatch):
    """render_depths sends "triton" to the binned kernel, "xla" and the CPU
    default to render_depth, and rejects anything else."""
    import meshrecon.raster.binned as B

    soup, valid = _sphere(cap=1024)
    cams = np.stack([g._make_camera(eye=(0.3, 0.2, 0.5))])
    calls = []

    def fake(c, s, v, h, w):
        calls.append((h, w))
        return jnp.zeros((c.shape[0], h, w), jnp.float32)

    monkeypatch.setattr(B, "render_depth_binned", fake)
    out = R.render_depths(cams, soup, valid, 24, 32, raster="triton")
    assert calls == [(24, 32)] and out.shape == (1, 24, 32)
    ref = np.asarray(R.render_depths(cams, soup, valid, 24, 32))
    np.testing.assert_array_equal(
        ref[0], _xla(cams[0], soup, valid, 24, 32))
    assert calls == [(24, 32)]
    with pytest.raises(ValueError):
        R.render_depths(cams, soup, valid, 24, 32, raster="pallas")


@pytest.mark.parametrize("t,cap", [(0, 256), (1, 256), (256, 256),
                                   (257, 1024), (5000, 16384),
                                   (16384, 16384), (65536, 65536),
                                   (65537, 262144)])
def test_soup_capacity_ladder(t, cap):
    assert R._soup_capacity(t) == cap


@pytest.mark.gpu
def test_compiled_kernel_matches_render_depth(gpu_device):
    """On the card: the compiled kernel against render_depth at 640x480."""
    soup = g._sphere_soup(n_theta=64, n_phi=128)
    soup, valid = _pad(soup[morton_order(soup)], 16384)
    cams = np.stack([g._make_camera(eye=(0.2 * i, 0.1, 0.3))
                     for i in range(4)]).astype(np.float32)
    with jax.default_device(gpu_device):
        out = np.asarray(render_depth_binned(cams, soup, valid, 480, 640))
        ref = np.asarray(R.render_depths(cams, soup, valid, 480, 640,
                                         raster="xla"))
    # FMA contraction may round an edge test the other way on a few pixels
    assert np.mean(np.abs(out - ref) > 1e-4) < 1e-3
