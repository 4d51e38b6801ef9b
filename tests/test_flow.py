import numpy as np
import jax.numpy as jnp
import pytest

from meshrecon.flow import pyr_down, pyr_up, compare, flow_remap, calculate_flow
from meshrecon.flow.variational import variational_flow
from meshrecon.flow.farneback import farneback_flow


def smooth_image(h, w, seed=0, octaves=4):
    """Band-limited random image, 0..255 scale (flow needs texture)."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w))
    for o in range(octaves):
        s = 2**o
        small = rng.normal(size=(max(2, h // (8 * s)) + 2, max(2, w // (8 * s)) + 2))
        yy = np.linspace(0, small.shape[0] - 1.001, h)
        xx = np.linspace(0, small.shape[1] - 1.001, w)
        yi, xi = np.floor(yy).astype(int), np.floor(xx).astype(int)
        fy, fx = (yy - yi)[:, None], (xx - xi)[None, :]
        v = (
            small[yi][:, xi] * (1 - fy) * (1 - fx)
            + small[yi][:, xi + 1] * (1 - fy) * fx
            + small[yi + 1][:, xi] * fy * (1 - fx)
            + small[yi + 1][:, xi + 1] * fy * fx
        )
        img += v / (o + 1)
    img -= img.min()
    img *= 255.0 / max(img.max(), 1e-6)
    return img.astype(np.float32)


def shift_image(img, dx, dy):
    """Shift by integer pixels: out(r, c) = img(r - dy, c - dx)."""
    out = np.roll(np.roll(img, dy, axis=0), dx, axis=1)
    return out


def test_pyr_down_up_shapes():
    img = jnp.asarray(smooth_image(37, 53))
    d = pyr_down(img)
    assert d.shape == (19, 27)
    u = pyr_up(d, (37, 53))
    assert u.shape == (37, 53)
    # energy roughly preserved
    assert abs(float(jnp.mean(u)) - float(jnp.mean(img))) < 10.0


def test_compare_zero_for_identical():
    img = smooth_image(40, 48)
    var = np.asarray(compare(img, img))
    assert np.allclose(var, 0.0, atol=1e-3)


def test_compare_positive_for_shift():
    img = smooth_image(40, 48, seed=1)
    var = np.asarray(compare(img, shift_image(img, 3, 0)))
    assert var.mean() > 1.0


def test_flow_remap_identity():
    img = smooth_image(32, 40, seed=2)
    flow = np.zeros((32, 40, 4), np.float32)
    out = np.asarray(flow_remap(flow, img))
    np.testing.assert_allclose(out[2:-2, 2:-2], img[2:-2, 2:-2], atol=1e-3)


def test_flow_remap_integer_shift():
    img = smooth_image(32, 40, seed=3)
    flow = np.zeros((32, 40, 2), np.float32)
    flow[..., 0] = 2.0  # sample at col + 2
    out = np.asarray(flow_remap(flow, img))
    np.testing.assert_allclose(out[4:-4, 4:-8], img[4:-4, 6:-6], atol=1e-2)


@pytest.mark.parametrize("algo", ["variational", "farneback"])
def test_flow_recovers_translation(algo):
    img = smooth_image(72, 96, seed=4)
    dx, dy = 3, -2
    # moved(r, c) = img(r - dy, c - dx): flow from img->moved should be (dx, dy)
    # under the convention moved(x + flow) = img(x) -> flow = -(dx, dy)?
    # Reference convention: next(x + flow(x)) ~= prev(x). next = moved,
    # prev = img. moved(c + fx) = img(c) requires fx = -dx ... but
    # moved(c) = img(c - dx) so moved(c + dx)? moved at col c+dx equals
    # img(c). Hence fx = +dx... careful: moved(r,c) = img(r-dy, c-dx).
    # moved(r + dy, c + dx) = img(r, c). So flow = (+dx, +dy).
    moved = shift_image(img, dx, dy)
    fn = variational_flow if algo == "variational" else farneback_flow
    flow = np.asarray(fn(img, moved))
    interior = flow[12:-12, 12:-12]
    err = np.hypot(interior[..., 0] - dx, interior[..., 1] - dy)
    assert np.median(err) < 0.5, f"median flow error {np.median(err)}"


def test_calculate_flow_contract_and_selfcheck():
    img = smooth_image(64, 80, seed=5)
    moved = shift_image(img, 2, 1)
    out = np.asarray(calculate_flow(img, moved))
    assert out.shape == (64, 80, 4)
    assert np.all(out[..., 3] == 0.0)
    # remap-error self-check (flow.cpp:133): warping `moved` by the flow must
    # reconstruct `img` much better than not warping
    remapped = np.asarray(flow_remap(out, moved))
    err_with = np.abs(remapped[8:-8, 8:-8] - img[8:-8, 8:-8]).mean()
    err_without = np.abs(moved[8:-8, 8:-8] - img[8:-8, 8:-8]).mean()
    assert err_with < 0.3 * err_without
    # variance channel should be small where the flow is good
    assert np.median(out[8:-8, 8:-8, 2]) < np.median(
        np.asarray(compare(img, moved))[8:-8, 8:-8]
    )


def test_shift_warp_matches_gather_warp():
    """Shift-decomposed warps are exact (vs gather-based) for |flow| <= R."""
    import jax.numpy as jnp

    from meshrecon.flow.shiftwarp import shift_warp_bilinear, shift_warp_bicubic
    from meshrecon.flow.remap import bicubic_remap
    from meshrecon.raster.fragment import bilinear_sample

    rng = np.random.default_rng(9)
    img = rng.uniform(0, 255, (40, 56)).astype(np.float32)
    fx = rng.uniform(-5, 5, (40, 56)).astype(np.float32)
    fy = rng.uniform(-5, 5, (40, 56)).astype(np.float32)
    cols = np.arange(56, dtype=np.float32)[None, :]
    rows = np.arange(40, dtype=np.float32)[:, None]

    out_shift = np.asarray(shift_warp_bilinear(img, fx, fy, radius=6))
    ref = np.asarray(bilinear_sample(jnp.asarray(img), cols + fx, rows + fy))
    interior = np.zeros((40, 56), bool)
    interior[8:-8, 8:-8] = True
    np.testing.assert_allclose(out_shift[interior], ref[interior], atol=1e-3)

    out_cubic = np.asarray(shift_warp_bicubic(img, fx, fy, radius=6))
    ref_cubic = np.asarray(bicubic_remap(img, cols + fx, rows + fy))
    np.testing.assert_allclose(out_cubic[interior], ref_cubic[interior],
                               atol=1e-2)


def test_flow_recovers_large_translation():
    """Regression: the pyramid must recover displacements far beyond any
    warp clamp radius (a shift-decomposed warp in the solver once broke
    this: 20 px came back as 36 px)."""
    img = smooth_image(240, 320, seed=4)
    for d in (20, 40):
        moved = shift_image(img, d, 0)
        # deep pyramid: large displacements are the standalone-solver
        # capability this test pins; the PIPELINE default is 3 levels
        # (flows against rendered predictions, round 4)
        flow = np.asarray(variational_flow(img, moved, levels=6))
        interior = flow[40:-40, 60:-60]
        err = np.abs(interior[..., 0] - d)
        assert np.median(err) < 1.0, f"shift {d}: med err {np.median(err)}"


def test_cheb_coeffs_are_affine_combinations():
    from meshrecon.flow.variational import cheb_coeffs

    for iters in (1, 7, 20, 60):
        ab = cheb_coeffs(iters, 0.995)
        assert len(ab) == iters
        for a, b in ab:
            assert abs(a + b - 1.0) < 1e-9
        assert ab[0] == (1.0, 0.0)


def test_cheb_outconverges_jacobi():
    """20 Chebyshev sweeps (rho=0.98 default) must beat 60 plain Jacobi
    sweeps in distance to the true fixed point of the same linear system.
    Measured: cheb20 max/mean error 0.39/0.071 vs jacobi60 1.15/0.295."""
    import jax.numpy as jnp

    from meshrecon.flow.variational import _hs_sweeps, _hs_sweeps_cheb

    img = smooth_image(64, 80, seed=6)
    moved = shift_image(img, 1, 2).astype(np.float32)
    a = jnp.asarray(img)
    b = jnp.asarray(moved)
    u0 = jnp.zeros_like(a)
    v0 = jnp.zeros_like(a)
    alpha2 = jnp.float32(144.0)

    ustar, vstar = _hs_sweeps(a, b, u0, v0, alpha2, 4000)

    def fp_err(u, v):
        e = jnp.hypot(u - ustar, v - vstar)[4:-4, 4:-4]
        return float(jnp.mean(e))

    uj, vj = _hs_sweeps(a, b, u0, v0, alpha2, 60)
    uc, vc = _hs_sweeps_cheb(a, b, u0, v0, alpha2, 20)
    err_j = fp_err(uj, vj)
    err_c = fp_err(uc, vc)
    assert err_c < 0.5 * err_j, f"cheb20 {err_c} vs jacobi60 {err_j}"


@pytest.mark.parametrize("solver", ["cheb"])
def test_flow_recovers_translation_cheb(solver):
    img = smooth_image(72, 96, seed=4)
    dx, dy = 3, -2
    moved = shift_image(img, dx, dy)
    flow = np.asarray(variational_flow(img, moved, solver=solver))
    interior = flow[12:-12, 12:-12]
    err = np.hypot(interior[..., 0] - dx, interior[..., 1] - dy)
    assert np.median(err) < 0.5, f"median flow error {np.median(err)}"


def test_flow_recovers_large_translation_cheb():
    img = smooth_image(240, 320, seed=4)
    moved = shift_image(img, 40, 0)
    flow = np.asarray(variational_flow(img, moved, solver="cheb", levels=6))
    interior = flow[40:-40, 60:-60]
    err = np.abs(interior[..., 0] - 40)
    assert np.median(err) < 1.0, f"med err {np.median(err)}"


def test_want_residual_matches_true_rewarp():
    """variational_flow(want_residual=True): the first-order re-warped
    image must (a) leave the flow itself bit-identical, and (b) agree with
    a TRUE re-gather of next_ at the final flow up to the first-order
    error of the last solve increment (sub-pixel by construction)."""
    a = smooth_image(64, 96, seed=3)
    b = shift_image(a, 2, 1)
    flow_plain = np.asarray(variational_flow(a, b, levels=6))
    flow, rewarped = variational_flow(a, b, levels=6,
                                      want_residual=True)
    np.testing.assert_array_equal(np.asarray(flow), flow_plain)
    true_rewarp = np.asarray(flow_remap(jnp.asarray(flow), jnp.asarray(b)))
    # interior only: the roll-shift wraps content at the border
    d = np.abs(np.asarray(rewarped) - true_rewarp)[8:-8, 8:-8]
    assert np.median(d) < 2.0, np.median(d)  # 0..255 image scale
    # and the implied variance estimate ranks with the true one
    var_t = np.asarray(compare(jnp.asarray(a), rewarped))[8:-8, 8:-8]
    var_r = np.asarray(compare(jnp.asarray(a), jnp.asarray(true_rewarp)))[
        8:-8, 8:-8]
    # first-order re-warp: rank agreement, not equality (measured 0.946 on
    # this fixture — the increment at the finest level IS the whole
    # fine-scale correction with fine_warps=1). The e2e quality harness
    # gates whether "taylor" may become the production default.
    cc = np.corrcoef(var_t.ravel(), var_r.ravel())[0, 1]
    assert cc > 0.90, cc


def test_flow_warps_knob():
    """The coarse-warps knob (set_flow_knobs(warps=...) / --flow-warps):
    warps=1 must still recover a moderate translation (the knob exists to
    skip the coarse re-linearization pass, not to break the pyramid), and
    the knob must plumb through set_flow_knobs and restore on 0."""
    from meshrecon.flow import variational as V

    img = smooth_image(72, 96, seed=4)
    dx, dy = 3, -2
    moved = shift_image(img, dx, dy)
    try:
        V.set_flow_knobs(warps=1)
        assert V._FLOW_WARPS == 1
        flow = np.asarray(variational_flow(img, moved, solver="cheb"))
    finally:
        V.set_flow_knobs(warps=0)
    assert V._FLOW_WARPS == 0
    interior = flow[12:-12, 12:-12]
    err = np.hypot(interior[..., 0] - dx, interior[..., 1] - dy)
    assert np.median(err) < 0.5, f"median flow error {np.median(err)}"


def test_flow_warps_config_plumbing(tmp_path):
    """--flow-warps reaches the solver module through apply_kernel_knobs
    and a zero knob restores the import-time default."""
    from meshrecon.flow import variational as V
    from meshrecon.pipeline.config import Config, apply_kernel_knobs

    # minimal attribute surface: apply_kernel_knobs reads every knob via
    # getattr(..., default), so a bare instance exercises the defaults path
    cfg = Config.__new__(Config)
    try:
        cfg.flow_warps = 1
        apply_kernel_knobs(cfg)
        assert V._FLOW_WARPS == 1
        cfg.flow_warps = 0
        apply_kernel_knobs(cfg)
        assert V._FLOW_WARPS == V._DEFAULTS[3]
    finally:
        V.set_flow_knobs(warps=V._DEFAULTS[3])
