"""Camera model and homogeneous-coordinate geometry (pure jnp, batch-friendly).

Conventions (identical to the reference program's):

- A *camera* is a single 4x4 projection matrix ``P`` mapping world-space
  homogeneous points to clip space; NDC = clip.xyz / clip.w with x, y, z all
  in [-1, 1]. The matrices come straight from the Blender exporter
  (``io_export_tracks.py:22-28`` builds ``PerspectiveMatrix * camera_inv *
  zflip``).
- Depth maps store NDC z; empty pixels hold ``BACKGROUND_DEPTH == 1.0``
  (reference ``recon.hpp:30``, ``render_glx.cpp:395`` remaps the GL z-buffer
  by ``2*z - 1`` to NDC before returning).
- Image rows run top-down: NDC y = +1 is image row 0. This matches the
  reference which flips GL framebuffers after readback and computes
  ``y = (centerY - row) * 2 / height`` in ``util.cpp:188``.

All functions are written for jnp arrays but accept numpy input; every op is
shape-polymorphic over leading batch dimensions where noted, so the same code
path serves single cameras on the host and vmapped/sharded batches on the
device.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def dehomogenize(points):
    """(..., 4) homogeneous -> (..., 3) Cartesian. Reference: util.cpp:16-29."""
    points = jnp.asarray(points)
    return points[..., :3] / points[..., 3:4]


def extract_camera_center(camera):
    """Center of a 4x4 camera matrix as a homogeneous 4-vector.

    The reference (util.cpp:33-41) forms a 3x4 pinhole matrix from rows
    {0, 1, 3} of the 4x4 (x, y and w rows; the z row only encodes depth) and
    takes its null space via cv::decomposeProjectionMatrix. We do the same
    with an SVD null-vector. Returns shape (..., 4); not normalized.
    """
    camera = jnp.asarray(camera)
    p34 = camera[..., (0, 1, 3), :]  # (..., 3, 4)
    # Null space: right-singular vector with the smallest singular value.
    _, _, vt = jnp.linalg.svd(p34)
    center = vt[..., -1, :]
    # Fix an arbitrary sign so that w >= 0 when possible (stable orientation).
    sign = jnp.where(center[..., 3:4] < 0, -1.0, 1.0)
    return center * sign


def camera_to_screen(points3, lens_distortion, aspect):
    """Apply the exporter's radial lens distortion model to NDC points.

    ``points3``: (..., 3) Cartesian NDC points. Radius is computed from
    (x, y*aspect)/2 and the polynomial ``k = 1 + r^2*(k1 + r^2*k2)`` scales the
    whole point, exactly like the reference (configuration.cpp:250-258).
    """
    points3 = jnp.asarray(points3)
    k1, k2 = float(lens_distortion[0]), float(lens_distortion[1])
    rad2 = (points3[..., 0] ** 2 + (points3[..., 1] * aspect) ** 2) / 4.0
    k = 1.0 + rad2 * (k1 + rad2 * k2)
    return points3 * k[..., None]


def project_points(camera, points4, lens_distortion=None, aspect=1.0):
    """Project homogeneous world points by a camera; optionally distort.

    camera: (4, 4); points4: (N, 4). Returns (N, 3) Cartesian NDC points.
    Mirrors Configuration::projectPoints (configuration.cpp:262-267).
    """
    projected = jnp.matmul(jnp.asarray(points4), jnp.asarray(camera).T,
                           precision=jax.lax.Precision.HIGHEST)
    cart = dehomogenize(projected)
    if lens_distortion is not None:
        cart = camera_to_screen(cart, lens_distortion, aspect)
    return cart


def ndc_to_pixel(x, y, width, height):
    """NDC (x, y) -> continuous pixel (col, row); y=+1 is row 0.

    Matches the overlay convention of the reference GLX test
    (render_glx.cpp:421): col = w*(0.5 + x/2), row = h*(0.5 - y/2).
    """
    col = (x + 1.0) * 0.5 * width
    row = (1.0 - y) * 0.5 * height
    return col, row


def pixel_to_ndc(col, row, width, height):
    """Continuous pixel (col, row) -> NDC (x, y).

    Matches util.cpp:185-188: x = (col - w/2) * 2/w, y = (h/2 - row) * 2/h.
    """
    x = (col - width / 2.0) * (2.0 / width)
    y = (height / 2.0 - row) * (2.0 / height)
    return x, y


def pixel_grid_ndc(width, height, dtype=jnp.float32):
    """NDC coordinates of every pixel center index (col, row) as two (H, W) arrays.

    Uses integer pixel indices like the reference per-pixel loops
    (util.cpp:180-188), i.e. the grid point for (row, col) is
    ``x = (col - w/2) * 2/w``.
    """
    cols = jnp.arange(width, dtype=dtype)
    rows = jnp.arange(height, dtype=dtype)
    x = (cols - width / 2.0) * (2.0 / width)
    y = (height / 2.0 - rows) * (2.0 / height)
    return jnp.broadcast_to(x[None, :], (height, width)), jnp.broadcast_to(
        y[:, None], (height, width)
    )


def homogenize(points3, w=1.0):
    """(..., 3) -> (..., 4) with the given w."""
    points3 = jnp.asarray(points3)
    ones = jnp.full(points3.shape[:-1] + (1,), w, dtype=points3.dtype)
    return jnp.concatenate([points3, ones], axis=-1)


def np_extract_camera_center(camera: np.ndarray) -> np.ndarray:
    """NumPy twin of extract_camera_center for host-side policy code."""
    p34 = np.asarray(camera, dtype=np.float64)[(0, 1, 3), :]
    _, _, vt = np.linalg.svd(p34)
    center = vt[-1, :]
    if center[3] < 0:
        center = -center
    return center.astype(np.float32)
