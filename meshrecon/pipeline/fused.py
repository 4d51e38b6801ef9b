"""The fused per-main-camera update: one jitted program for the whole hot
loop body of recon.cpp:65-119.

The unfused path dispatches ~10 device programs per main camera (depth
render, then per side: shadow render, projection, background mix, flow;
finally triangulation and normals) with host round trips in between. This
module compiles the entire loop body into a single program: the side loop
is a ``lax.scan`` carrying the progressively-masked depth map (the reference
mutates `depth` in place across side projections, util.cpp:366-387), and the
renderer, flow solver, triangulator and normal estimator all fuse into one
XLA executable per (H, W, K-bucket) shape.

Every float32 contraction here runs at ``Precision.HIGHEST``: a GPU would
otherwise run it in TF32 (about three decimal digits), which moves
reprojected coordinates and the Gauss-Newton inputs by far more than the
reference's float32 arithmetic does.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp

from meshrecon.depth import triangulate_pixels, estimate_normals
from meshrecon.flow.pyramid import compare
from meshrecon.flow.remap import flow_remap
from meshrecon.flow.variational import variational_flow
from meshrecon.flow.farneback import farneback_flow
from meshrecon.raster.rasterizer import render_depths
from meshrecon.raster.fragment import (projected_image,
                                       projected_image_batched,
                                       mix_background)


_HI = jax.lax.Precision.HIGHEST

# Variance-estimate mode: "rewarp" re-gathers the mixed stack with the
# final flow (bicubic flow_remap, the literal analog of util.cpp:332-361's
# remap-then-compare); "taylor" reuses the flow solver's final warp +
# gradients for a first-order re-warp (see variational_flow(
# want_residual=True)) — same compare() cascade on top, no second gather
# pass. Default taylor: the quality gates measured it within camera-draw
# noise at 1/8-res and full-res (BASELINE.md "taylor variance gate";
# PARITY.md divergence 14). `--variance-mode rewarp` (env
# MESHRECON_VARIANCE) restores the literal remap-then-compare.
_VARIANCE_MODE = os.environ.get("MESHRECON_VARIANCE", "taylor")
_DEFAULT_VARIANCE = _VARIANCE_MODE


def set_variance_mode(mode: str | None = None):
    """Set the variance-estimate mode mid-process (config/CLI plumbing);
    clears jit caches so traces that baked the old value cannot go stale."""
    global _VARIANCE_MODE
    if mode is None:
        return
    if mode not in ("rewarp", "taylor"):
        raise ValueError(f"variance mode must be rewarp|taylor: {mode!r}")
    if mode != _VARIANCE_MODE:
        _VARIANCE_MODE = mode
        jax.clear_caches()


@functools.partial(
    jax.jit,
    static_argnames=("height", "width", "use_farneback", "raster",
                     "sampling", "flow_solver", "variance"),
)
def fused_main_update_batched(soup, soup_valid, cam_mains, frames_main,
                              side_cams, side_frames, side_valid, centers,
                              centers_valid, n_side, height: int, width: int,
                              use_farneback: bool = False,
                              raster: str | None = None,
                              sampling: str = "taylor",
                              flow_solver: str = "cheb",
                              variance: str | None = None):
    """Full dense update for B main cameras x K (padded) sides each — the
    production step of reconstruct.py's camera-bundle batching.

    soup: (T, 3, 3) world triangles + (T,) validity (shared — the mesh is
    global state like the reference's single VBO, render_glx.cpp:230-258);
    cam_mains: (B, 4, 4); frames_main: (B, H, W); side_cams: (B, K, 4, 4);
    side_frames: (B, K, H, W); side_valid: (B, K); centers: (B, C, 3);
    centers_valid: (B, C); n_side: (B,).

    Natively batched rather than ``jax.vmap`` of the single-camera update:
    the B*(K+1) depth renders are one raster launch and the B*K dense
    sampling passes one gather each.

    raster: depth renderer, "triton" | "xla" | None (raster_engine's
    choice for the backend; see raster/rasterizer.render_depths).

    Returns dict(point4, normals, pdf, valid, depth), all with leading B.
    """
    frames_main = jnp.asarray(frames_main, jnp.float32)
    side_cams = jnp.asarray(side_cams, jnp.float32)
    side_frames = jnp.asarray(side_frames, jnp.float32)
    side_valid = jnp.asarray(side_valid)
    b, k = side_frames.shape[:2]

    # Stage 1a — ALL depth renders (B mains + B*K sides) in one batched
    # raster dispatch. The reference renders each from the same static mesh
    # (render_glx.cpp:261-397), so they are independent.
    all_cams = jnp.concatenate([cam_mains[:, None], side_cams], axis=1)
    all_depths = render_depths(
        all_cams.reshape(b * (k + 1), 4, 4), soup, soup_valid, height, width,
        raster).reshape(b, k + 1, height, width)
    depth0 = all_depths[:, 0]

    # Stage 1b — BATCHED projective texturing. The reference's projected()
    # rasterizes the PRISTINE mesh for every side (render_glx.cpp:261-367);
    # only mixBackground's carried depth couples the sides
    # (util.cpp:366-387), so all B*K projections run in one pass and the
    # sequential part reduces to the cheap elementwise mix chain below.
    intens, masks = projected_image_batched(cam_mains, depth0, side_frames,
                                            side_cams, all_depths[:, 1:])

    # Stage 1c — sequential background-mix chain (each side's mix sees the
    # previous side's masked depth, exactly like the in-place mutation at
    # util.cpp:366-387). K is a small static bucket: unrolled Python loop.
    depth = depth0
    mixed_list = []
    for i in range(k):
        mixed, new_depth = mix_background(intens[:, i], masks[:, i],
                                          frames_main, depth)
        # padded sides: leave the depth untouched, weight the flow out later
        depth = jnp.where(side_valid[:, i, None, None], new_depth, depth)
        mixed_list.append(mixed)
    depth_final = depth
    mixed_all = jnp.stack(mixed_list, axis=1)  # (B, K, H, W)

    # Stage 2 — ONE batched flow solve over all B*K (main, side) pairs:
    # relaxation sweeps and pyramid ops widen elementwise, and each level's
    # warp is one gather over the whole stack.
    var_mode = variance or _VARIANCE_MODE
    rewarped = None
    if use_farneback:
        # size-dependent parameters like flow.cpp:24-26 (same as api.py)
        sigma = max((height + width) / 1000.0, 0.7)
        flows2 = jax.vmap(jax.vmap(
            lambda fm, mixed: farneback_flow(
                fm, mixed,
                poly_n=5 if sigma < 1.5 else 7,
                poly_sigma=sigma,
                winsize=int(max((height + width) // 100, 5))),
            in_axes=(None, 0)))(frames_main, mixed_all)
    elif var_mode == "taylor":
        # cross-stage fusion: the flow solve's final warp + gradients give
        # the re-warped stack to first order in the last solve increment —
        # no second gather pass (variational_flow docstring; the compare()
        # cascade below is identical to the rewarp path)
        # levels=2, warps=1 (explicit, not the library defaults): flows
        # against RENDERED predictions have few-pixel residuals
        # (variational.py docstring) — the quality gates measured the
        # shallow single-warp pyramid with a LOWER
        # photometric self-check error and e2e quality within draw noise
        # at 1/8 and full res (BASELINE.md "lv2 flow-pyramid gate";
        # --flow-levels 3 / --flow-warps 2 restore the round-4 config)
        flows2, rewarped = variational_flow(frames_main[:, None], mixed_all,
                                            solver=flow_solver, levels=2,
                                            warps=1, want_residual=True)
    else:
        flows2 = variational_flow(frames_main[:, None], mixed_all,
                                  solver=flow_solver, levels=2, warps=1)

    if rewarped is None:
        # bicubic re-warp for the variance estimate (util.cpp:390-403)
        rewarped = jax.vmap(jax.vmap(flow_remap))(flows2, mixed_all)
    var = compare(frames_main[:, None], rewarped)  # (B, K, H, W)

    # channel PLANES straight into the triangulator — no (B,K,H,W,4)
    # concat (a pure HBM round trip + a dead zeros pad channel; the
    # CV_32FC4 layout survives only at the public API, flow.cpp:37-41)
    out = jax.vmap(
        lambda fx, fy, vv, cm, sc, sv, d: triangulate_pixels(
            (fx, fy, vv), cm, sc, sv, d, sampling=sampling)
    )(flows2[..., 0], flows2[..., 1], var,
      cam_mains, side_cams, side_valid, depth_final)
    normals = jax.vmap(estimate_normals)(out["point4"], out["valid"],
                                         out["pdf"], centers, centers_valid,
                                         n_side)
    return {
        "point4": out["point4"],
        "normals": normals,
        "pdf": out["pdf"],
        "valid": out["valid"],
        "depth": depth_final,
    }


@functools.partial(
    jax.jit,
    static_argnames=("height", "width", "use_farneback", "raster",
                     "sampling", "flow_solver", "variance"),
)
def fused_main_update(soup, soup_valid, cam_main, frame_main, side_cams,
                      side_frames, side_valid, centers, centers_valid, n_side,
                      height: int, width: int, use_farneback: bool = False,
                      raster: str | None = None, sampling: str = "taylor",
                      flow_solver: str = "cheb",
                      variance: str | None = None):
    """Full dense update for ONE main camera against K (padded) sides —
    the B=1 slice of :func:`fused_main_update_batched` (same program,
    same semantics; see there for the stage structure).

    soup: (T, 3, 3) world triangles + (T,) validity; cam_main: (4, 4);
    frame_main: (H, W); side_cams: (K, 4, 4); side_frames: (K, H, W);
    side_valid: (K,); centers: (C, 3) camera centers (main first);
    centers_valid: (C,); n_side: scalar int.

    Returns dict(point4, normals, pdf, valid, depth).
    """
    out = fused_main_update_batched(
        soup, soup_valid, jnp.asarray(cam_main, jnp.float32)[None],
        jnp.asarray(frame_main, jnp.float32)[None],
        jnp.asarray(side_cams, jnp.float32)[None],
        jnp.asarray(side_frames, jnp.float32)[None],
        jnp.asarray(side_valid)[None],
        jnp.asarray(centers, jnp.float32)[None],
        jnp.asarray(centers_valid)[None],
        jnp.asarray(n_side)[None],
        height=height, width=width, use_farneback=use_farneback,
        raster=raster, sampling=sampling, flow_solver=flow_solver,
        variance=variance,
    )
    return jax.tree_util.tree_map(lambda x: x[0], out)


def splat_visibility(pts4, valid, side_cams, height: int,
                     width: int, tol: float = 0.01):
    """Per-side visibility of a depth-map surface WITHOUT a mesh.

    pts4 (B, H, W, 4): homogeneous world points of the main view's current
    surface estimate; valid (B, H, W). side_cams (B, K, 4, 4).
    Returns (B, K, H, W) bool: main pixels whose point is the nearest
    surface claiming its side-view pixel (z-test against a forward point
    splat). This replaces the mesh shadow map when the estimate exists only
    as a depth map (the second plane-sweep pass): project every main pixel
    into the side view, scatter-min its side-NDC z over a 2x2 footprint
    (closes quantization gaps for side views magnifying up to 2x; larger
    magnification can still leave gaps), then each pixel is visible iff
    its own z is within a slope-adaptive ``tol`` of the winning splat —
    the same bias constant as the mesh shadow test
    (fragment.py::projected_image).
    """
    b, k = side_cams.shape[:2]
    h, w = pts4.shape[1:3]
    proj = jnp.einsum("bkij,bhwj->bkhwi", jnp.asarray(side_cams, jnp.float32),
                      jnp.asarray(pts4, jnp.float32), precision=_HI)
    sw = proj[..., 3]
    behind = sw <= 1e-6
    sw_safe = jnp.where(jnp.abs(sw) < 1e-6, 1e-6, sw)
    sx = proj[..., 0] / sw_safe
    sy = proj[..., 1] / sw_safe
    sz = proj[..., 2] / sw_safe
    scol = (sx + 1.0) * 0.5 * width
    srow = (1.0 - sy) * 0.5 * height
    inframe = (sx > -1.0) & (sx < 1.0) & (sy > -1.0) & (sy < 1.0) & ~behind
    ok = valid[:, None] & inframe

    z = jnp.where(ok, sz, jnp.inf)
    r0 = jnp.clip(jnp.floor(srow), 0, height - 1).astype(jnp.int32)
    c0 = jnp.clip(jnp.floor(scol), 0, width - 1).astype(jnp.int32)
    r1 = jnp.minimum(r0 + 1, height - 1)
    c1 = jnp.minimum(c0 + 1, width - 1)

    def splat_one(rr0, cc0, rr1, cc1, z1):
        # 2x2 footprint: closes the quantization gaps a nearest-cell splat
        # leaves when the side view magnifies the surface (up to 2x) — a
        # gap would otherwise let occluded points peek through
        buf = jnp.full((height, width), jnp.inf, jnp.float32)
        zf = z1.ravel()
        for rr, cc in ((rr0, cc0), (rr0, cc1), (rr1, cc0), (rr1, cc1)):
            buf = buf.at[rr.ravel(), cc.ravel()].min(zf)
        return buf

    buf = jax.vmap(jax.vmap(splat_one))(r0, c0, r1, c1, z)
    rq = jnp.clip(jnp.round(srow), 0, height - 1).astype(jnp.int32)
    cq = jnp.clip(jnp.round(scol), 0, width - 1).astype(jnp.int32)
    won = jnp.take_along_axis(
        buf.reshape(b, k, height * width),
        (rq * width + cq).reshape(b, k, height * width), axis=2,
    ).reshape(b, k, height, width)
    # slope-adaptive bias: points sharing a cell with their own surface
    # neighbors differ in z by up to the local gradient x footprint radius
    # — an oblique surface must not occlude itself, while a genuine
    # occluder is a DIFFERENT surface whose z gap dwarfs the local slope.
    # Only valid-valid neighbor pairs contribute: behind-camera/off-frame
    # pixels hold garbage z (sw clamped to 1e-6), and an unmasked diff
    # would inflate the tolerance to ~infinity exactly at silhouette
    # boundaries, re-admitting genuinely occluded points.
    ok_u = ok & jnp.concatenate([ok[..., 1:], ok[..., -1:]], axis=-1)
    ok_v = ok & jnp.concatenate([ok[..., 1:, :], ok[..., -1:, :]], axis=-2)
    dzu = jnp.where(ok_u, jnp.abs(jnp.diff(sz, axis=-1, append=sz[..., -1:])),
                    0.0)
    dzv = jnp.where(ok_v,
                    jnp.abs(jnp.diff(sz, axis=-2, append=sz[..., -1:, :])),
                    0.0)
    tol_eff = tol + 2.0 * (dzu + dzv)
    return ok & (sz <= won + tol_eff)


@functools.partial(
    jax.jit,
    static_argnames=("height", "width", "num_depths", "raster", "passes"),
)
def fused_sweep_update_batched(soup, soup_valid, cam_mains, frames_main,
                               side_cams, side_frames, side_valid, centers,
                               centers_valid, n_side, height: int, width: int,
                               num_depths: int = 64,
                               raster: str | None = None,
                               passes: int = 1):
    """Plane-sweep analog of fused_main_update_batched: ONE program for B
    main cameras — all B*(K+1) depth renders, the per-side shadow-mapped
    visibility masks, per-camera z-range estimation, the batch-native plane
    sweep, point back-projection and normals.

    This kills the round-2 iteration-1 dispatch cadence (the hybrid
    default's first iteration ran one camera per dispatch with a PYTHON
    loop of renderer.projected calls for the visibility weights —
    reconstruct.py's unfused path; reference hot loop recon.cpp:65-119).

    Same argument convention as fused_main_update_batched. Returns
    dict(point4, normals, pdf, valid, depth) with leading B.
    """
    from meshrecon import BACKGROUND_DEPTH
    from meshrecon.depth.plane_sweep import plane_sweep_depth_batched

    frames_main = jnp.asarray(frames_main, jnp.float32)
    side_cams = jnp.asarray(side_cams, jnp.float32)
    side_frames = jnp.asarray(side_frames, jnp.float32)
    side_valid = jnp.asarray(side_valid)
    cam_mains = jnp.asarray(cam_mains, jnp.float32)
    b, k = side_frames.shape[:2]

    all_cams = jnp.concatenate([cam_mains[:, None], side_cams], axis=1)
    all_depths = render_depths(
        all_cams.reshape(b * (k + 1), 4, 4), soup, soup_valid, height, width,
        raster).reshape(b, k + 1, height, width)
    depth0 = all_depths[:, 0]

    # per-(side, pixel) visibility of the CURRENT surface estimate: the
    # sweep's vote weights (see plane_sweep_depth's side_weight contract)
    _, masks = projected_image_batched(cam_mains, depth0, side_frames,
                                       side_cams, all_depths[:, 1:])

    # per-camera sweep range from the current estimate's depth span
    # (the host path computed this in numpy; here it is in-program data)
    dvalid = depth0 < BACKGROUND_DEPTH
    big = jnp.float32(3e38)
    zlo = jnp.min(jnp.where(dvalid, depth0, big), axis=(1, 2))
    zhi = jnp.max(jnp.where(dvalid, depth0, -big), axis=(1, 2))
    any_valid = jnp.any(dvalid, axis=(1, 2))
    zlo = jnp.where(any_valid, zlo, -1.0)
    zhi = jnp.where(any_valid, zhi, 1.0)
    span = jnp.maximum(zhi - zlo, 0.05)
    zlo = zlo - 0.1 * span
    zhi = zhi + 0.1 * span

    out = plane_sweep_depth_batched(
        frames_main, side_frames, cam_mains, side_cams, side_valid,
        zlo, zhi, num_depths=num_depths,
        side_weight=masks.astype(jnp.float32))

    main_inv = jnp.linalg.inv(cam_mains)
    cols = (jnp.arange(width, dtype=jnp.float32) - width / 2.0) * (
        2.0 / width)
    rows = (height / 2.0 - jnp.arange(height, dtype=jnp.float32)) * (
        2.0 / height)
    x = jnp.broadcast_to(cols[None, None, :], (b, height, width))
    y = jnp.broadcast_to(rows[None, :, None], (b, height, width))

    def backproject(depth):
        ndc4 = jnp.stack([x, y, depth, jnp.ones_like(x)], axis=-1)
        return jnp.einsum("bij,bhwj->bhwi", main_inv, ndc4, precision=_HI)

    for _ in range(passes - 1):
        # re-sweep with the visibility of the CURRENT swept surface — the
        # iteration-1 alpha-shape mesh is crude and its wrong shadow masks
        # are where the signed deep bias concentrates; the swept depth map
        # itself is the better occluder (splat_visibility, no mesh needed)
        vis1 = out["valid"] & dvalid
        masks2 = splat_visibility(backproject(out["depth"]), vis1,
                                  side_cams, height, width)
        out = plane_sweep_depth_batched(
            frames_main, side_frames, cam_mains, side_cams, side_valid,
            zlo, zhi, num_depths=num_depths,
            side_weight=masks2.astype(jnp.float32))

    valid = out["valid"] & dvalid & any_valid[:, None, None]
    pts4 = backproject(out["depth"])
    pdf = 1.0 / (1.0 + out["cost"])

    normals = jax.vmap(estimate_normals)(pts4, valid, pdf, centers,
                                         centers_valid, n_side)
    return {
        "point4": pts4.astype(jnp.float32),
        "normals": normals,
        "pdf": pdf.astype(jnp.float32),
        "valid": valid,
        "depth": depth0,
    }
