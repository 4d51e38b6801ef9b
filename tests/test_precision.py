"""Every float32 contraction on the dense paths runs at Precision.HIGHEST.

A GPU runs an unpinned float32 dot_general in TF32 (about three decimal
digits), which the CPU never does, so the CPU cannot show the error
itself. What it can show is the jaxpr: this audit walks each program's
jaxpr, nested programs included, and fails on any float contraction whose
precision is not HIGHEST on both operands.
"""

import jax
import jax.extend
import jax.numpy as jnp
import numpy as np
import pytest

import __graft_entry__ as g

_HI = jax.lax.Precision.HIGHEST


def _sub_jaxprs(eqn):
    for v in eqn.params.values():
        for x in (v if isinstance(v, (list, tuple)) else (v,)):
            if isinstance(x, jax.extend.core.ClosedJaxpr):
                yield x.jaxpr
            elif isinstance(x, jax.extend.core.Jaxpr):
                yield x


def _contractions(jaxpr):
    """(precision, operand dtypes) of every dot_general, recursively."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append((eqn.params["precision"],
                        tuple(str(v.aval.dtype) for v in eqn.invars)))
        for sub in _sub_jaxprs(eqn):
            out.extend(_contractions(sub))
    return out


def _unpinned(fn, *args):
    found = _contractions(jax.make_jaxpr(fn)(*args).jaxpr)
    assert found, "audit found no contraction at all: the walk is broken"
    return [(p, dt) for p, dt in found
            if any(d.startswith("float") for d in dt)
            and p != (_HI, _HI)]


def _fused_args(b=1, k=2, h=16, w=24):
    return g._fused_problem(b=b, k=k, h=h, w=w, seed=0, n_tris=64)


def _sweep_args():
    rng = np.random.default_rng(0)
    b, k, h, w = 1, 2, 16, 24
    cams = np.stack([g._make_camera(eye=(0.1 * i, 0, 0))
                     for i in range(b)]).astype(np.float32)
    sides = np.stack([np.stack([g._make_camera(eye=(0.5, 0.2 * j, 0))
                                for j in range(k)])]).astype(np.float32)
    return (rng.uniform(0, 255, (b, h, w)).astype(np.float32),
            rng.uniform(0, 255, (b, k, h, w)).astype(np.float32),
            cams, sides, np.ones((b, k), bool),
            np.full(b, -0.5, np.float32), np.full(b, 0.5, np.float32))


def _case_fused_main():
    from meshrecon.pipeline.fused import fused_main_update_batched

    return (lambda *a: fused_main_update_batched(*a, height=16, width=24),
            _fused_args())


def _case_fused_main_farneback():
    from meshrecon.pipeline.fused import fused_main_update_batched

    return (lambda *a: fused_main_update_batched(*a, height=16, width=24,
                                                 use_farneback=True,
                                                 variance="rewarp"),
            _fused_args())


def _case_fused_sweep():
    from meshrecon.pipeline.fused import fused_sweep_update_batched

    return (lambda *a: fused_sweep_update_batched(*a, height=16, width=24,
                                                  num_depths=4, passes=2),
            _fused_args())


def _case_projected_image():
    from meshrecon.raster.fragment import projected_image

    cam = g._make_camera()
    side = g._make_camera(eye=(0.5, 0, 0))
    d = np.full((16, 24), 0.5, np.float32)
    return projected_image, (cam, d, d, side, d)


def _case_projected_image_batched():
    from meshrecon.raster.fragment import projected_image_batched

    cams = np.stack([g._make_camera()])
    sides = np.stack([np.stack([g._make_camera(eye=(0.5, 0, 0))] * 2)])
    d = np.full((1, 16, 24), 0.5, np.float32)
    ds = np.full((1, 2, 16, 24), 0.5, np.float32)
    return projected_image_batched, (cams, d, ds, sides, ds)


def _case_plane_sweep():
    from meshrecon.depth.plane_sweep import plane_sweep_depth_batched

    return (lambda *a: plane_sweep_depth_batched(*a, num_depths=4),
            _sweep_args())


def _case_farneback():
    from meshrecon.flow.farneback import farneback_flow

    rng = np.random.default_rng(1)
    a = rng.uniform(0, 255, (32, 40)).astype(np.float32)
    return farneback_flow, (a, a)


def _case_exposure():
    from meshrecon.pipeline.exposure import _exposure_iterations

    rng = np.random.default_rng(2)
    return _exposure_iterations, (
        rng.uniform(10, 200, (3, 8, 3)).astype(np.float32),
        np.ones((3, 8), np.float32))


def _case_synthetic_sphere():
    from meshrecon.io.synthetic import _render_sphere_frames

    cams = np.stack([g._make_camera()])
    return (lambda c: _render_sphere_frames(c, jnp.zeros(3), 1.0, 16, 24,
                                            0),
            (cams,))


def _case_synthetic_plane():
    from meshrecon.io.synthetic import _render_plane_frames

    cams = np.stack([g._make_camera()])
    return (lambda c: _render_plane_frames(
        c, jnp.asarray([0.0, 0.0, -5.0]), jnp.asarray([0.0, 0.0, 1.0]),
        3.0, 16, 24, 0), (cams,))


_CASES = {
    "fused_main_update_batched": _case_fused_main,
    "fused_main_update_batched_farneback_rewarp": _case_fused_main_farneback,
    "fused_sweep_update_batched": _case_fused_sweep,
    "projected_image": _case_projected_image,
    "projected_image_batched": _case_projected_image_batched,
    "plane_sweep_depth_batched": _case_plane_sweep,
    "farneback_flow": _case_farneback,
    "exposure_solve": _case_exposure,
    "synthetic_sphere": _case_synthetic_sphere,
    "synthetic_plane": _case_synthetic_plane,
}


@pytest.mark.parametrize("name", sorted(_CASES))
def test_contractions_pinned_highest(name):
    fn, args = _CASES[name]()
    bad = _unpinned(fn, *args)
    assert not bad, f"{name}: float contractions below HIGHEST: {bad}"


@pytest.mark.gpu
def test_fused_update_gpu_matches_cpu(gpu_device):
    """On the card: the fused update against the same update on the CPU,
    chip_smoke.py's precision check at 160x120 on the koule sphere. The two
    differ in raster engine and summation order only; a TF32 contraction
    would move points by ~1e-3 r everywhere."""
    import chip_smoke as cs
    from meshrecon.geometry.camera import np_extract_camera_center
    from meshrecon.io.synthetic import synthetic_frames
    from meshrecon.pipeline.fused import fused_main_update_batched

    h, w = 120, 160
    track, center, radius = cs.koule_scene()
    frames = synthetic_frames(track, w, h, mode="sphere", seed=0)
    soup, valid, _ = cs.sphere_soup(4096, center, radius)
    mains, sides = cs.bundle_cameras(track)
    cam = track.cameras
    b, k = len(mains), len(sides[0])
    centers = np.zeros((b, 8, 3), np.float32)
    for i, (m, s) in enumerate(zip(mains, sides)):
        for j, c in enumerate([m] + s):
            p = np_extract_camera_center(cam[c])
            centers[i, j] = p[:3] / p[3]
    cvalid = np.zeros((b, 8), bool)
    cvalid[:, :k + 1] = True
    args = (soup, valid, cam[mains].astype(np.float32), frames[mains],
            np.stack([cam[s] for s in sides]).astype(np.float32),
            np.stack([frames[s] for s in sides]), np.ones((b, k), bool),
            centers, cvalid, np.full(b, k, np.int32))

    def run(device, raster):
        with jax.default_device(device):
            out = jax.jit(lambda *a: fused_main_update_batched(
                *a, height=h, width=w, raster=raster))(
                    *jax.device_put(args, device))
            return jax.tree_util.tree_map(np.asarray, out)

    gpu = run(gpu_device, "triton")
    cpu = run(jax.devices("cpu")[0], "xla")
    both = gpu["valid"] & cpu["valid"]
    p_g = gpu["point4"][..., :3] / gpu["point4"][..., 3:4]
    p_c = cpu["point4"][..., :3] / cpu["point4"][..., 3:4]
    perr = np.linalg.norm(p_g - p_c, axis=-1)[both] / radius
    unit = (both & (np.linalg.norm(gpu["normals"], axis=-1) > 0.5)
            & (np.linalg.norm(cpu["normals"], axis=-1) > 0.5))
    cosang = np.abs(np.sum(gpu["normals"] * cpu["normals"], -1))[unit]
    nerr = np.degrees(np.arccos(np.clip(cosang, 0, 1)))
    assert np.mean(gpu["valid"] == cpu["valid"]) >= 0.995
    assert np.median(perr) <= 1e-4
    assert np.percentile(perr, 99) <= 1e-2
    assert np.median(nerr) <= 0.1
