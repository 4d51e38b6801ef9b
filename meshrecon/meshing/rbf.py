"""RBF implicit-surface reconstruction (the reference's experimental
``rbfSurface`` backend, pcl.cpp:231-244, implemented as dense device math).

Classic Carr-style thin-plate RBF fit: constraints are the surface points
(f = 0) plus off-surface points offset along the normals (f = ±eps); the
dense symmetric system is solved once in float64 on the host (the |r|^3
kernel is too ill-conditioned for f32), and evaluation over the marching grid
is a single (G^3, N) @ (N,) matmul — exactly the shape accelerators love. Surface
extraction reuses the marching-tetrahedra stage of the Poisson path.

Practical for clouds up to a few thousand points (the dense system is
(2N+4)^2); larger clouds are subsampled, which matches the experimental
status of the reference backend.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from meshrecon.io.obj import Mesh
from meshrecon.meshing.poisson import marching_tetrahedra

_HI = jax.lax.Precision.HIGHEST


def _phi(r):
    return r * r * r  # triharmonic kernel |r|^3 (smooth in 3-D)


def _rbf_fit_host(centers, values):
    """Dense thin-plate fit in float64 on the host: the |r|^3 system is far
    too ill-conditioned for an f32 device solve; the one-time (2N+4)^2 solve
    is cheap next to the grid evaluation, which stays on the device."""
    n = len(centers)
    diff = centers[:, None, :] - centers[None, :, :]
    a = _phi(np.sqrt(np.maximum(np.sum(diff * diff, -1), 1e-30)))
    p = np.concatenate([np.ones((n, 1)), centers], axis=1)
    m = np.zeros((n + 4, n + 4))
    m[:n, :n] = a
    m[:n, n:] = p
    m[n:, :n] = p.T
    rhs = np.concatenate([values, np.zeros(4)])
    sol = np.linalg.solve(m, rhs)
    return sol[:n], sol[n:]


@functools.partial(jax.jit, static_argnames=("grid",))
def _rbf_eval_grid(centers, w, c, lo, scale, grid=64):
    """Evaluate the fitted RBF over the marching grid: one (G^3, N) matmul."""
    g = grid
    gx = jnp.arange(g, dtype=jnp.float32) / scale
    pts = jnp.stack(jnp.meshgrid(gx + lo[0], gx + lo[1], gx + lo[2],
                                 indexing="ij"), axis=-1).reshape(-1, 3)
    d = pts[:, None, :] - centers[None, :, :]
    r = jnp.sqrt(jnp.maximum(jnp.sum(d * d, -1), 1e-20))
    f = jnp.dot(_phi(r), w, precision=_HI)
    f = f + c[0] + pts @ c[1:]
    return f.reshape(g, g, g)


def rbf_surface(points, normals, grid: int = 64, max_points: int = 1500,
                offset_frac: float = 0.01, margin: float = 0.15,
                seed: int = 0) -> Mesh:
    """Reconstruct a closed mesh via a thin-plate RBF implicit fit.

    points: (N, 4) homogeneous or (N, 3); normals: (N, 3) oriented outward.
    Returns a Mesh with outward-oriented faces (same contract as
    poisson_surface).
    """
    pts = np.asarray(points, np.float64)
    if pts.shape[1] == 4:
        pts = pts[:, :3] / pts[:, 3:4]
    nrm = np.asarray(normals, np.float64)
    lens = np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm = nrm / np.maximum(lens, 1e-12)
    if len(pts) == 0:
        return Mesh(np.zeros((0, 4), np.float32), np.zeros((0, 3), np.int32))

    if len(pts) > max_points:
        sel = np.random.default_rng(seed).choice(len(pts), max_points,
                                                 replace=False)
        pts, nrm = pts[sel], nrm[sel]

    span = float(np.max(pts.max(axis=0) - pts.min(axis=0)))
    span = max(span, 1e-6)
    # normalize to a unit box for conditioning
    origin = pts.min(axis=0)
    pts_n = (pts - origin) / span
    eps = offset_frac
    # signed constraints on both sides of the surface (Carr-style)
    centers = np.concatenate(
        [pts_n, pts_n + eps * nrm, pts_n - eps * nrm]
    )
    values = np.concatenate(
        [np.zeros(len(pts)), np.full(len(pts), eps),
         np.full(len(pts), -eps)]
    )
    w, c = _rbf_fit_host(centers, values)

    lo_n = pts_n.min(axis=0) - margin
    scale_n = (grid - 1.0) / (1.0 + 2.0 * margin)
    f = np.asarray(
        _rbf_eval_grid(
            jnp.asarray(centers, jnp.float32), jnp.asarray(w, jnp.float32),
            jnp.asarray(c, jnp.float32), jnp.asarray(lo_n, jnp.float32),
            jnp.float32(scale_n), grid=grid,
        )
    )
    lo = origin + lo_n * span
    scale = scale_n / span
    # our marching stage treats "inside" as chi > iso; f is positive OUTSIDE
    verts_grid, faces = marching_tetrahedra(-f, 0.0)
    verts_world = verts_grid / scale + lo
    verts4 = np.concatenate(
        [verts_world, np.ones((len(verts_world), 1), np.float32)], axis=1
    ).astype(np.float32)
    return Mesh(verts4, faces)
