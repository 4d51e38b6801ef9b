"""Fused per-pixel depth triangulation — the numerical core of the pipeline.

Re-architecture of triangulatePixels/triangulatePixel (util.cpp:62-246): the
reference runs a scalar 1-D Gauss-Newton per pixel in a double loop; here the
whole (K, H, W) problem is one jitted program of fused elementwise arrays —
every quantity in the solver is affine in the single unknown z, so each GN
step is a handful of elementwise ops per (pixel, side-camera) pair.

Layout note: every dense intermediate is a PLANE — (H, W) or (K, H, W)
with the image dims last; small channel axes are unstacked into planes.

Sampling modes (static arg):
- ``exact``: bilinear depth/gradient samples at the flow-displaced position
  (goodSample semantics, util.cpp:44-53, 207-217) — data-dependent gathers.
- ``taylor``: first-order expansion ``z(p+f) ~= z(p) + g . f`` using the
  Sobel gradient already computed (and the center gradient for the
  covariance). No gathers at all. The
  displaced-position validity check degrades to center validity. Within the
  pipeline, flows against the rendered prediction are small, so the
  first-order error is far below the flow variance.

Semantics preserved from the reference (exact mode):

- measured point per side camera: sample the depth map at the flow-displaced
  position when all four bilinear neighbors are valid, else keep the center
  depth (goodSample, util.cpp:44-53, 207-208); project
  ``C_i @ M^-1 @ (x + fx*sx, y + fy*sy, z, 1)`` (util.cpp:209).
- per-camera inverse covariance ``inv(A A^T) / variance`` where
  ``A = C_i[0:2,0:3] M^-1[0:3,0:3] D / w`` and D carries the depth-map Sobel
  gradient (util.cpp:211-223). NOTE: the reference samples its float gradient
  through an integer cv::Point type pun (util.cpp:215-217) which reinterprets
  float bits as ints; we implement the evident intent — bilinear float
  sampling — instead of the pun.
- pixels where any side camera sees z < -1 are dropped (util.cpp:229-233).
- GN on z: derivative uses the frozen Jacobian approximation
  ``dp/dz = (C_i M^-1)[0:2, 2] / w_i(z)`` (util.cpp:104-108), step
  ``dz = -first/second``, at most 50 iterations, stop at |dz| < 1e-7
  (util.cpp:125-126); convergence is a per-pixel mask here (jit-stable).
- density ``pdf = 0.159 * prod(det(icov_i)) * exp(-0.5 sum r^T icov r)``
  (util.cpp:128-141).
- output point is ``M^-1 @ (x, y, z*, 1)`` homogeneous (util.cpp:163).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from meshrecon import BACKGROUND_DEPTH

_HI = jax.lax.Precision.HIGHEST

# GN straggler-tail exit (see gn_cond below): stop full-plane sweeps once
# at most _GN_TAIL unconverged pixels remain after _GN_MIN_SWEEPS sweeps.
_GN_TAIL = 64
_GN_MIN_SWEEPS = 6


def sobel_gradient(image):
    """Unnormalized 3x3 Sobel (gx, gy), reflect-101 borders (util.cpp:465-479)."""
    p = jnp.pad(image, 1, mode="reflect")
    h, w = image.shape

    def sl(dr, dc):
        return p[1 + dr : 1 + dr + h, 1 + dc : 1 + dc + w]

    gx = (
        (sl(-1, 1) - sl(-1, -1))
        + 2.0 * (sl(0, 1) - sl(0, -1))
        + (sl(1, 1) - sl(1, -1))
    )
    gy = (
        (sl(1, -1) - sl(-1, -1))
        + 2.0 * (sl(1, 0) - sl(-1, 0))
        + (sl(1, 1) - sl(-1, 1))
    )
    return gx, gy


def _bilinear_plane(plane, col, row):
    """Bilinear sample of an (H, W) plane at (..., H, W) positions; also
    returns the 4 corner values (for validity tests). Clamped indices."""
    h, w = plane.shape
    c0 = jnp.floor(col).astype(jnp.int32)
    r0 = jnp.floor(row).astype(jnp.int32)
    inside = (c0 >= 1) & (c0 < w - 1) & (r0 >= 1) & (r0 < h - 1)
    c0c = jnp.clip(c0, 0, w - 2)
    r0c = jnp.clip(r0, 0, h - 2)
    v00 = plane[r0c, c0c]
    v01 = plane[r0c, c0c + 1]
    v10 = plane[r0c + 1, c0c]
    v11 = plane[r0c + 1, c0c + 1]
    fc = col - c0c
    fr = row - r0c
    val = (
        v00 * (1 - fr) * (1 - fc)
        + v01 * (1 - fr) * fc
        + v10 * fr * (1 - fc)
        + v11 * fr * fc
    )
    return val, (v00, v01, v10, v11), inside


@functools.partial(jax.jit, static_argnames=("gn_iters", "sampling"))
def triangulate_pixels(flows, main_camera, side_cameras, side_valid, depth,
                       gn_iters: int = 50, sampling: str = "exact"):
    """Triangulate every valid pixel of the main frame against K side flows.

    flows: (K, H, W, 4) (fx, fy, variance, 0) — or a tuple of three
    (K, H, W) channel planes ``(fx, fy, variance)``. The fused pipeline
    passes planes: packing the channels into a minor-4 tensor only for
    this function to unstack them again costs a pure memory round trip
    and a dead zeros
    channel (the CV_32FC4 pad, flow.cpp:37-41, exists only at the public
    API surface). main_camera: (4, 4);
    side_cameras: (K, 4, 4); side_valid: (K,) bool mask (capacity padding —
    K can be bucket-padded so one compiled program serves many camera
    bundles); depth: (H, W) NDC depth with background = 1.0.

    Returns dict with: ``point4`` (H, W, 4) homogeneous world points,
    ``pdf`` (H, W) triangulation density, ``valid`` (H, W) bool.
    """
    if isinstance(flows, (tuple, list)):
        flx_in, fly_in, var_in = (jnp.asarray(f, jnp.float32) for f in flows)
    else:
        flows = jnp.asarray(flows, jnp.float32)
        flx_in, fly_in, var_in = (flows[..., 0], flows[..., 1],
                                  flows[..., 2])
    main_camera = jnp.asarray(main_camera, jnp.float32)
    side_cameras = jnp.asarray(side_cameras, jnp.float32)
    depth = jnp.asarray(depth, jnp.float32)
    k, h, w = flx_in.shape[0], depth.shape[0], depth.shape[1]
    side_valid = jnp.asarray(side_valid, bool)

    main_inv = jnp.linalg.inv(main_camera)
    cm = jnp.einsum("kij,jl->kil", side_cameras, main_inv, precision=_HI)

    def cmc(i, j):  # scalar (K, 1, 1) broadcastable component of C M^-1
        return cm[:, i, j][:, None, None]

    cols = jnp.arange(w, dtype=jnp.float32)[None, :]
    rows = jnp.arange(h, dtype=jnp.float32)[:, None]
    sx, sy = 2.0 / w, 2.0 / h
    x = (cols - w / 2.0) * sx * jnp.ones((h, 1), jnp.float32)
    y = (h / 2.0 - rows) * sy * jnp.ones((1, w), jnp.float32)
    center_valid = depth != BACKGROUND_DEPTH

    gx, gy = sobel_gradient(depth)

    # flow channels in plane layout (see the flows tuple form above)
    flx = flx_in
    fly = fly_in
    # variance floor: uint8 quantization noise alone has variance ~1/12;
    # synthetic or perfectly-predicted frames can drive compare() to ~0,
    # which explodes det(icov) = 1/(det(S) var^2) and with it the pdf
    variance = jnp.maximum(var_in, 1e-2)

    if sampling == "exact":
        fcol = cols[None] + flx
        frow = rows[None] + fly

        def samp(plane):
            val, corners, inside = _bilinear_plane(plane, fcol, frow)
            return val, corners, inside

        zs, (z00, z01, z10, z11), inside = samp(depth)
        good = (
            inside
            & (z00 != BACKGROUND_DEPTH) & (z01 != BACKGROUND_DEPTH)
            & (z10 != BACKGROUND_DEPTH) & (z11 != BACKGROUND_DEPTH)
        )
        zk = jnp.where(good, zs, depth[None])
        gxs, _, _ = _bilinear_plane(gx, fcol, frow)
        gys, _, _ = _bilinear_plane(gy, fcol, frow)
        g1 = jnp.where(good, gxs, gx[None])
        g2 = jnp.where(good, gys, gy[None])
    elif sampling == "taylor":
        # Sobel is 8x the central-difference derivative per pixel step
        zk = depth[None] + (gx[None] * flx + gy[None] * fly) / 8.0
        zk = jnp.clip(zk, -1.0, 1.0)
        # validity: the displaced position must stay in-frame; depth validity
        # degrades to the center pixel's
        fcol = cols[None] + flx
        frow = rows[None] + fly
        good = (
            (fcol >= 1) & (fcol < w - 1) & (frow >= 1) & (frow < h - 1)
            & center_valid[None]
        )
        zk = jnp.where(good, zk, depth[None])
        g1 = jnp.broadcast_to(gx[None], zk.shape)
        g2 = jnp.broadcast_to(gy[None], zk.shape)
    else:
        raise ValueError(f"unknown sampling mode {sampling}")

    # measured point: m = C M^-1 @ (x + fx sx, y + fy sy, zk, 1), planes
    mx_in = x[None] + flx * sx
    my_in = y[None] + fly * sy

    def apply_cm(row):
        return (
            cmc(row, 0) * mx_in + cmc(row, 1) * my_in
            + cmc(row, 2) * zk + cmc(row, 3)
        )

    m0, m1, m2, m3 = apply_cm(0), apply_cm(1), apply_cm(2), apply_cm(3)
    mw_safe = jnp.where(jnp.abs(m3) < 1e-12, 1e-12, m3)
    sx_meas = m0 / mw_safe
    sy_meas = m1 / mw_safe
    mz_ndc = m2 / mw_safe
    ok_pixel = center_valid & jnp.all(
        jnp.where(side_valid[:, None, None], mz_ndc >= -1.0, True), axis=0
    )

    # A = B + outer(c3, g), scaled by 1/mw; icov = inv(A A^T) / variance
    a11 = (cmc(0, 0) + cmc(0, 2) * g1) / mw_safe
    a12 = (cmc(0, 1) + cmc(0, 2) * g2) / mw_safe
    a21 = (cmc(1, 0) + cmc(1, 2) * g1) / mw_safe
    a22 = (cmc(1, 1) + cmc(1, 2) * g2) / mw_safe
    s11 = a11 * a11 + a12 * a12
    s12 = a11 * a21 + a12 * a22
    s22 = a21 * a21 + a22 * a22
    det_s = s11 * s22 - s12 * s12
    det_s = jnp.where(jnp.abs(det_s) < 1e-20, 1e-20, det_s)
    ic11 = s22 / (det_s * variance)
    ic12 = -s12 / (det_s * variance)
    ic22 = s11 / (det_s * variance)
    vmask = side_valid[:, None, None].astype(jnp.float32)
    ic11, ic12, ic22 = ic11 * vmask, ic12 * vmask, ic22 * vmask

    # --- Gauss-Newton on z: projections are affine in z ---
    n0x = cmc(0, 0) * x[None] + cmc(0, 1) * y[None] + cmc(0, 3)
    n0y = cmc(1, 0) * x[None] + cmc(1, 1) * y[None] + cmc(1, 3)
    w0 = cmc(3, 0) * x[None] + cmc(3, 1) * y[None] + cmc(3, 3)
    nzx, nzy, wz = cmc(0, 2), cmc(1, 2), cmc(3, 2)
    pdx, pdy = nzx, nzy  # frozen Jacobian numerators (util.cpp:86)

    def residuals(z):
        # ONE reciprocal instead of four divisions per sweep (the GN loop
        # runs this over (K, H, W) every iteration)
        wi = w0 + wz * z[None]
        wi = jnp.where(jnp.abs(wi) < 1e-12, 1e-12, wi)
        inv_wi = 1.0 / wi
        rx = (n0x + nzx * z[None]) * inv_wi - sx_meas
        ry = (n0y + nzy * z[None]) * inv_wi - sy_meas
        return rx, ry, inv_wi

    def gn_body(_, state):
        z, active = state
        rx, ry, inv_wi = residuals(z)
        dpx = pdx * inv_wi
        dpy = pdy * inv_wi
        tx = ic11 * dpx + ic12 * dpy
        ty = ic12 * dpx + ic22 * dpy
        first = jnp.sum(rx * tx + ry * ty, axis=0)
        second = jnp.sum(dpx * tx + dpy * ty, axis=0)
        second = jnp.where(jnp.abs(second) < 1e-30, 1e-30, second)
        dz = -first / second
        step = jnp.where(active, dz, 0.0)
        active = active & (jnp.abs(dz) >= 1e-7)
        return z + step, active

    # while_loop with a global convergence exit: the reference caps at 50
    # scalar iterations per pixel (util.cpp:126) but typical convergence is
    # a handful of steps. On a CPU only the unconverged PIXEL pays the tail
    # iterations; under SPMD every pixel pays every sweep, and the measured
    # bench fixture converges 78379 -> 71 -> 3 -> 1 active by sweep 4 with
    # ONE oscillating straggler then dragging all 307k pixels through all
    # 50 sweeps. The exit therefore also fires
    # once <= _GN_TAIL stragglers remain after >= _GN_MIN_SWEEPS sweeps:
    # those pixels are GN limit cycles at degenerate geometry (near-zero
    # parallax flips dz sign forever) — the reference leaves them
    # mid-oscillation after 50 sweeps, we leave them mid-oscillation after
    # >= 6; both are unconverged, and the e2e/harness regression gates
    # bound the effect (none measurable).
    def gn_cond(state):
        _, active, it = state
        n_active = jnp.sum(active.astype(jnp.int32))
        tail = jnp.where(it < _GN_MIN_SWEEPS, 0, _GN_TAIL)
        return (n_active > tail) & (it < gn_iters)

    def gn_step(state):
        z, active, it = state
        z, active = gn_body(it, (z, active))
        return z, active, it + 1

    # only valid pixels iterate (the reference loops over valid pixels only,
    # util.cpp:183); background pixels would never converge and defeat the
    # early exit
    z0 = depth
    z_final, _, _ = jax.lax.while_loop(
        gn_cond, gn_step,
        (z0, center_valid & ok_pixel, jnp.int32(0)),
    )

    # points whose solved depth leaves the main frustum are divergences of
    # the GN (the initial z comes from the [-1, 1] depth buffer); the
    # reference has no such guard but its outliers poison everything
    # downstream (a single far point inflates the Poisson grid bbox until the
    # real surface is sub-voxel)
    ok_pixel &= (z_final >= -1.0) & (z_final <= 1.0)

    # density of the result (util.cpp:128-141)
    rx, ry, _ = residuals(z_final)
    quad = rx * (ic11 * rx + ic12 * ry) + ry * (ic12 * rx + ic22 * ry)
    exponent = -jnp.sum(quad, axis=0)
    det_ic = ic11 * ic22 - ic12 * ic12
    det_ic = jnp.where(side_valid[:, None, None],
                       jnp.maximum(det_ic, 1e-30), 1.0)
    # the reference computes this product in double (util.cpp:129-141); in f32
    # we accumulate in log space and clamp to avoid overflow to inf
    log_pdf = (
        jnp.log(jnp.float32(0.159))
        + jnp.sum(jnp.log(det_ic), axis=0)
        + 0.5 * exponent
    )
    # clip keeps per-camera confidence ratios bounded so no camera's points
    # drown the others in the Poisson splat (f32-safe too)
    pdf = jnp.exp(jnp.clip(log_pdf, -30.0, 30.0))

    # output point: M^-1 @ (x, y, z*, 1) as planes, stacked once at the API
    # boundary
    def apply_minv(row):
        mi = main_inv[row]
        return mi[0] * x + mi[1] * y + mi[2] * z_final + mi[3]

    point4 = jnp.stack(
        [apply_minv(0), apply_minv(1), apply_minv(2), apply_minv(3)], axis=-1
    )
    return {"point4": point4, "pdf": pdf, "valid": ok_pixel}
