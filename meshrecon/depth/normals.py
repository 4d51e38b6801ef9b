"""Per-pixel surface normals from neighborhood PCA, via windowed moment sums.

Re-architecture of the normal-estimation pass of triangulatePixels
(util.cpp:250-326): the reference gathers a 21x21 pixel neighborhood of
triangulated points for every pixel and runs cv::PCA on it — an O(radius^2)
gather per pixel. Here the same covariance comes from box-filtered moment
images (p, p p^T, count) followed by a closed-form smallest-eigenvector solve
of the 3x3 covariance — all fused elementwise work.

Layout notes:
- moment channels ride the LEADING axis ((C, H, W)), so every channel is a
  contiguous image plane.
- box sums use a binary shifted-add cascade (static slices).
- the 3x3 eigenvector solve is the analytic trigonometric method on plane
  arguments; batched jnp.linalg.eigh is orders of magnitude slower.

Semantics preserved:

- window half-size radius = 10 (util.cpp:253), only triangulated (valid)
  neighbors contribute (util.cpp:282-293).
- normal = eigenvector of the smallest eigenvalue (util.cpp:299-301).
- orientation: flip when ``sum_i 1 / (n . (c_i - p)) < 0`` over all camera
  centers (main first), the reference's inverse-distance vote
  (util.cpp:303-310).
- fallback for < 3 neighbors: ``sum_i (c_i - p) / |c_i - p|^2``
  (util.cpp:314-321).
- output scaled by ``pdf^(1/K) / |n|`` (pdf root only when K > 1,
  util.cpp:277-279, 324).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _window_sums_chw(field, radius):
    """Sum of (C, H, W) field over (2r+1)^2 spatial windows (zero outside).

    Binary decomposition of the box size into power-of-two window sums built
    by doubling — O(log size) shifted adds, all static slices on the aligned
    trailing (H, W) dims.
    """
    size = 2 * radius + 1

    def _suffix_box(x, axis):
        n = x.shape[axis]

        def shift(a, s):
            if s == 0:
                return a
            pad = [(0, 0)] * a.ndim
            pad[axis] = (0, s)
            idx = [slice(None)] * a.ndim
            idx[axis] = slice(s, s + n)
            return jnp.pad(a, pad)[tuple(idx)]

        pows = {1: x}
        k = 1
        while k * 2 <= size:
            pows[k * 2] = pows[k] + shift(pows[k], k)
            k *= 2
        acc = None
        offset = 0
        b = 1
        while b <= size:
            if size & b:
                term = shift(pows[b], offset)
                acc = term if acc is None else acc + term
                offset += b
            b *= 2
        return acc

    def centered_box(x, axis):
        pad = [(0, 0)] * x.ndim
        pad[axis] = (radius, radius)
        xp = jnp.pad(x, pad)
        acc = _suffix_box(xp, axis)
        idx = [slice(None)] * x.ndim
        idx[axis] = slice(0, x.shape[axis])
        return acc[tuple(idx)]

    return centered_box(centered_box(field, 1), 2)


def _smallest_eigvec_3x3_planes(a00, a11, a22, a01, a02, a12):
    """Unit eigenvector (3 planes) of the smallest eigenvalue of a symmetric
    3x3 given as 6 plane arrays. Analytic trigonometric eigenvalues + largest
    cross-product row extraction."""
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * (
        a01 * a01 + a02 * a02 + a12 * a12
    )
    p = jnp.sqrt(jnp.maximum(p2 / 6.0, 1e-30))
    inv_p = 1.0 / p
    c00, c11, c22 = b00 * inv_p, b11 * inv_p, b22 * inv_p
    c01, c02, c12 = a01 * inv_p, a02 * inv_p, a12 * inv_p
    half_det = (
        c00 * (c11 * c22 - c12 * c12)
        - c01 * (c01 * c22 - c12 * c02)
        + c02 * (c01 * c12 - c11 * c02)
    ) * 0.5
    half_det = jnp.clip(half_det, -1.0, 1.0)
    phi = jnp.arccos(half_det) / 3.0
    lam = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)

    r0x, r0y, r0z = a00 - lam, a01, a02
    r1x, r1y, r1z = a01, a11 - lam, a12
    r2x, r2y, r2z = a02, a12, a22 - lam

    def cross(ax, ay, az, bx, by, bz):
        return ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx

    cax, cay, caz = cross(r0x, r0y, r0z, r1x, r1y, r1z)
    cbx, cby, cbz = cross(r0x, r0y, r0z, r2x, r2y, r2z)
    ccx, ccy, ccz = cross(r1x, r1y, r1z, r2x, r2y, r2z)
    na = cax * cax + cay * cay + caz * caz
    nb = cbx * cbx + cby * cby + cbz * cbz
    nc = ccx * ccx + ccy * ccy + ccz * ccz

    use_b = nb > na
    bx = jnp.where(use_b, cbx, cax)
    by = jnp.where(use_b, cby, cay)
    bz = jnp.where(use_b, cbz, caz)
    nab = jnp.maximum(na, nb)
    use_c = nc > nab
    bx = jnp.where(use_c, ccx, bx)
    by = jnp.where(use_c, ccy, by)
    bz = jnp.where(use_c, ccz, bz)
    nbest = jnp.maximum(nab, nc)
    # degenerate (isotropic) fallback: +z
    degen = nbest <= 1e-30
    bx = jnp.where(degen, 0.0, bx)
    by = jnp.where(degen, 0.0, by)
    bz = jnp.where(degen, 1.0, bz)
    inv_n = 1.0 / jnp.sqrt(jnp.maximum(bx * bx + by * by + bz * bz, 1e-30))
    return bx * inv_n, by * inv_n, bz * inv_n


def _smallest_eigvec_3x3(cov, use_eigh: bool = False):
    """(..., 3, 3) API kept for tests; routes to the plane implementation."""
    if use_eigh:
        _, vecs = jnp.linalg.eigh(cov)
        return vecs[..., :, 0]
    vx, vy, vz = _smallest_eigvec_3x3_planes(
        cov[..., 0, 0], cov[..., 1, 1], cov[..., 2, 2],
        cov[..., 0, 1], cov[..., 0, 2], cov[..., 1, 2],
    )
    return jnp.stack([vx, vy, vz], axis=-1)


@functools.partial(jax.jit, static_argnames=("radius",))
def estimate_normals(point4, valid, pdf, camera_centers, centers_valid,
                     n_side: jnp.ndarray, radius: int = 10):
    """Estimate confidence-scaled normals for each triangulated pixel.

    point4: (H, W, 4); valid: (H, W) bool; pdf: (H, W); camera_centers:
    (C, 3) Cartesian centers (main camera first, like util.cpp:255-261);
    centers_valid: (C,) bool; n_side: scalar int (number of real side
    cameras, for the pdf root). Returns (H, W, 3) float32 normals.
    """
    point4 = jnp.asarray(point4, jnp.float32)
    w4 = point4[..., 3]
    w4 = jnp.where(jnp.abs(w4) < 1e-20, 1.0, w4)  # invalid pixels may have w=0
    vmask = valid.astype(jnp.float32)
    px = point4[..., 0] / w4 * vmask
    py = point4[..., 1] / w4 * vmask
    pz = point4[..., 2] / w4 * vmask

    moments = jnp.stack(
        [
            vmask,
            px, py, pz,
            px * px, py * py, pz * pz,
            px * py, px * pz, py * pz,
        ],
        axis=0,
    )  # (10, H, W)
    sums = _window_sums_chw(moments, radius)
    cnt = sums[0]
    n = jnp.maximum(cnt, 1.0)
    mx, my, mz = sums[1] / n, sums[2] / n, sums[3] / n
    cxx = sums[4] / n - mx * mx
    cyy = sums[5] / n - my * my
    czz = sums[6] / n - mz * mz
    cxy = sums[7] / n - mx * my
    cxz = sums[8] / n - mx * mz
    cyz = sums[9] / n - my * mz

    eps = 1e-12
    nx, ny, nz = _smallest_eigvec_3x3_planes(
        cxx + eps, cyy + eps, czz + eps, cxy, cxz, cyz
    )

    centers = jnp.asarray(camera_centers, jnp.float32)  # (C, 3)
    cmask = centers_valid.astype(jnp.float32)

    # orientation vote: sum_i 1 / (n . (c_i - p)); flip when negative.
    # plane math per center (loop over the handful of cameras)
    vote = jnp.zeros_like(nx)
    fbx = jnp.zeros_like(nx)
    fby = jnp.zeros_like(nx)
    fbz = jnp.zeros_like(nx)
    for i in range(centers.shape[0]):
        dx = centers[i, 0] - px
        dy = centers[i, 1] - py
        dz = centers[i, 2] - pz
        ndot = nx * dx + ny * dy + nz * dz
        ndot = jnp.where(jnp.abs(ndot) < 1e-12, 1e-12, ndot)
        vote = vote + cmask[i] / ndot
        d2 = jnp.maximum(dx * dx + dy * dy + dz * dz, 1e-12)
        fbx = fbx + cmask[i] * dx / d2
        fby = fby + cmask[i] * dy / d2
        fbz = fbz + cmask[i] * dz / d2

    flip = vote < 0
    nx = jnp.where(flip, -nx, nx)
    ny = jnp.where(flip, -ny, ny)
    nz = jnp.where(flip, -nz, nz)

    # fallback when the window holds fewer than 3 points
    few = cnt < 3.0
    nx = jnp.where(few, fbx, nx)
    ny = jnp.where(few, fby, ny)
    nz = jnp.where(few, fbz, nz)

    k = jnp.maximum(n_side.astype(jnp.float32), 1.0)
    pdf_root = jnp.where(k > 1.0, jnp.power(jnp.maximum(pdf, 0.0), 1.0 / k),
                         pdf)
    inv_len = 1.0 / jnp.maximum(
        jnp.sqrt(nx * nx + ny * ny + nz * nz), 1e-12
    )
    scale = pdf_root * inv_len * vmask
    out = jnp.stack([nx * scale, ny * scale, nz * scale], axis=-1)
    # a handful of pathological pixels (degenerate covariances at f32 edge
    # cases) can emit non-finite normals; one NaN would poison every
    # global reduction downstream (average-length normalization, the Poisson
    # splat), so sanitize here
    return jnp.where(jnp.isfinite(out), out, 0.0)
