"""Poisson-style surface reconstruction from oriented points, on the device.

Functional equivalent of the reference's CGAL Poisson stage
(``cgal_poisson.cpp:47-136``): build an indicator function whose gradient
matches the (confidence-scaled) oriented normal field, then extract its
iso-surface with outward-oriented triangles.

CGAL solves the Poisson equation with an adaptive FEM solve on a Delaunay
refinement; here we use the Fourier formulation on a regular grid — splat the
normal field into a voxel vector field V, solve ``laplacian(chi) = div V``
spectrally with one 3-D FFT (this is the classic Fourier/Kazhdan solid
reconstruction, and it maps perfectly onto an accelerator: the whole solve is three
rFFTs + an elementwise multiply + one irFFT in HBM), pick the iso level as
the mean of chi over the input samples, and run marching tetrahedra.

Normal magnitude acts as per-point confidence, like the reference's PCL
backend scales normals to unit *average* length (pcl.cpp:39-44) and the
triangulation stage scales normals by triangulation probability
(util.cpp:324).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from meshrecon.io.obj import Mesh


@functools.partial(jax.jit, static_argnames=("grid",))
def _indicator_grid(points3, normals, valid, lo, scale, grid=128, sigma=1.5):
    """Solve the Poisson indicator function on a regular grid.

    points3: (N, 3) Cartesian; normals: (N, 3) confidence-scaled; valid: (N,)
    mask (capacity padding); lo, scale: affine map world -> grid coords.
    Returns chi (G, G, G) float32, larger inside the solid.
    """
    g = grid
    pts = (points3 - lo) * scale  # grid coordinates
    base = jnp.floor(pts).astype(jnp.int32)
    frac = pts - base
    # points outside the (robust) grid bbox must not splat: their unclipped
    # trilinear weights would be unbounded
    inb = jnp.all((pts >= 0.0) & (pts <= g - 1.001), axis=-1)
    valid = valid * inb.astype(jnp.float32)

    vfield = jnp.zeros((g, g, g, 3), jnp.float32)
    wsum = jnp.zeros((), jnp.float32)
    # trilinear splat of each normal to the 8 surrounding voxels
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                wx = frac[:, 0] if dx else 1.0 - frac[:, 0]
                wy = frac[:, 1] if dy else 1.0 - frac[:, 1]
                wz = frac[:, 2] if dz else 1.0 - frac[:, 2]
                w = (wx * wy * wz) * valid
                idx = jnp.clip(base + jnp.array([dx, dy, dz]), 0, g - 1)
                vfield = vfield.at[idx[:, 0], idx[:, 1], idx[:, 2]].add(
                    normals * w[:, None]
                )

    # spectral solve: chi_hat = (i k . V_hat) / (-|k|^2), Gaussian-smoothed
    k1 = jnp.fft.fftfreq(g) * 2.0 * jnp.pi
    kz = jnp.fft.rfftfreq(g) * 2.0 * jnp.pi
    kxg, kyg, kzg = jnp.meshgrid(k1, k1, kz, indexing="ij")
    k2 = kxg**2 + kyg**2 + kzg**2
    smooth = jnp.exp(-0.5 * (sigma**2) * k2)

    vx = jnp.fft.rfftn(vfield[..., 0])
    vy = jnp.fft.rfftn(vfield[..., 1])
    vz = jnp.fft.rfftn(vfield[..., 2])
    div_hat = 1j * (kxg * vx + kyg * vy + kzg * vz)
    k2_safe = jnp.where(k2 == 0, 1.0, k2)
    # laplacian(chi) = div V  =>  -|k|^2 chi_hat = div_hat. With OUTWARD
    # normals that solution is larger outside; negate so chi is the
    # conventional indicator (larger inside the solid).
    chi_hat = jnp.where(k2 == 0, 0.0, div_hat / k2_safe) * smooth
    chi = jnp.fft.irfftn(chi_hat, s=(g, g, g)).astype(jnp.float32)
    return chi


def _trilinear(grid_vals, pts):
    """Sample (G,G,G) at float grid coords pts (N,3); numpy, clamped."""
    g = grid_vals.shape[0]
    p = np.clip(pts, 0.0, g - 1.001)
    b = np.floor(p).astype(np.int64)
    f = p - b
    out = np.zeros(len(p))
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = (
                    (f[:, 0] if dx else 1 - f[:, 0])
                    * (f[:, 1] if dy else 1 - f[:, 1])
                    * (f[:, 2] if dz else 1 - f[:, 2])
                )
                out += w * grid_vals[b[:, 0] + dx, b[:, 1] + dy, b[:, 2] + dz]
    return out


# marching-tetrahedra tables, derived (not copied): cube corner c has offset
# bits (x, y, z) = (c&1, (c>>1)&1, (c>>2)&1); six tets share diagonal 0-7
_CUBE_TETS = np.array(
    [
        [0, 1, 3, 7],
        [0, 3, 2, 7],
        [0, 2, 6, 7],
        [0, 6, 4, 7],
        [0, 4, 5, 7],
        [0, 5, 1, 7],
    ],
    dtype=np.int64,
)
# tet-local edges: index pairs into the 4 tet vertices
_TET_EDGES = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=np.int64
)


def _tet_case_table():
    """16-case table: for each inside-mask, up to 2 triangles of local edge ids.

    -1 pads unused slots. Winding is irrelevant here; triangles are oriented
    afterwards using the indicator gradient.
    """
    table = -np.ones((16, 2, 3), dtype=np.int64)
    edge_id = {(min(a, b), max(a, b)): i for i, (a, b) in enumerate(_TET_EDGES)}

    def e(a, b):
        return edge_id[(min(a, b), max(a, b))]

    for mask in range(1, 15):
        inside = [v for v in range(4) if mask & (1 << v)]
        outside = [v for v in range(4) if not mask & (1 << v)]
        if len(inside) == 1:
            a = inside[0]
            table[mask, 0] = [e(a, o) for o in outside]
        elif len(inside) == 3:
            a = outside[0]
            table[mask, 0] = [e(a, i) for i in inside]
        else:  # 2 inside: quad u-x, u-y, v-y, v-x
            u, v = inside
            x, y = outside
            quad = [e(u, x), e(u, y), e(v, y), e(v, x)]
            table[mask, 0] = [quad[0], quad[1], quad[2]]
            table[mask, 1] = [quad[0], quad[2], quad[3]]
    return table


_TET_CASES = _tet_case_table()


def marching_tetrahedra(chi: np.ndarray, iso: float):
    """Extract the iso-surface of a (G,G,G) scalar field; numpy vectorized.

    Returns (vertices (V, 3) float grid coords, faces (F, 3) int32) with
    deduplicated vertices and faces oriented so normals point outward (toward
    decreasing chi, i.e. away from the chi > iso solid).
    """
    try:
        from meshrecon.meshing.native import marching_tetrahedra_native

        out = marching_tetrahedra_native(chi, iso)
        if out is not None:
            return out
    except Exception:
        pass
    return _marching_tetrahedra_np(chi, iso)


def _marching_tetrahedra_np(chi: np.ndarray, iso: float):
    g = chi.shape[0]
    f = chi - iso

    # linear grid ids of cube corners for all cells
    ii, jj, kk = np.meshgrid(
        np.arange(g - 1), np.arange(g - 1), np.arange(g - 1), indexing="ij"
    )
    cell0 = (ii * g + jj) * g + kk  # id of corner (i, j, k)
    corner_off = np.array(
        [((c & 1) * g * g + ((c >> 1) & 1) * g + ((c >> 2) & 1)) for c in range(8)]
    )
    # global ids (Ncells, 8)
    gids = cell0.reshape(-1, 1) + corner_off[None, :]
    fvals = f.reshape(-1)

    # tets: (Ncells, 6, 4) global corner ids
    tets = gids[:, _CUBE_TETS].reshape(-1, 4)
    tf = fvals[tets]  # (Ntets, 4)
    inside = tf > 0.0
    mask = (
        inside[:, 0].astype(np.int64)
        + inside[:, 1] * 2
        + inside[:, 2] * 4
        + inside[:, 3] * 8
    )
    active = (mask > 0) & (mask < 15)
    if not np.any(active):
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    tets = tets[active]
    tf = tf[active]
    mask = mask[active]

    # up to 2 triangles per tet; collect (tri_local_edges) then drop -1 rows
    tri_edges = _TET_CASES[mask]  # (Nt, 2, 3)
    valid_tri = tri_edges[:, :, 0] >= 0  # (Nt, 2)
    tet_idx = np.repeat(np.arange(len(tets)), 2)[valid_tri.reshape(-1)]
    tri_e = tri_edges.reshape(-1, 3)[valid_tri.reshape(-1)]  # (F, 3) local edges

    # edge endpoints (global ids) per face corner
    va = tets[tet_idx[:, None], _TET_EDGES[tri_e][..., 0]]  # (F, 3)
    vb = tets[tet_idx[:, None], _TET_EDGES[tri_e][..., 1]]
    key_lo = np.minimum(va, vb)
    key_hi = np.maximum(va, vb)
    keys = key_lo.astype(np.int64) * (g * g * g) + key_hi

    uniq, inv = np.unique(keys.reshape(-1), return_inverse=True)
    faces = inv.reshape(-1, 3).astype(np.int32)

    # interpolate unique edge vertices
    ua = (uniq // (g * g * g)).astype(np.int64)
    ub = (uniq % (g * g * g)).astype(np.int64)
    fa, fb = fvals[ua], fvals[ub]
    t = fa / (fa - fb)
    t = np.clip(np.nan_to_num(t, nan=0.5), 0.0, 1.0)

    def unravel(lin):
        return np.stack([lin // (g * g), (lin // g) % g, lin % g], axis=-1)

    pa, pb = unravel(ua).astype(np.float64), unravel(ub).astype(np.float64)
    verts = pa + (pb - pa) * t[:, None]

    # drop degenerate faces (two corners on the same edge)
    ok = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    faces = faces[ok]

    # orient outward: flip triangles whose normal points along the gradient
    # (chi increases inward)
    grad = np.stack(np.gradient(f), axis=-1)  # (G,G,G,3)
    tri_pts = verts[faces]
    centroids = tri_pts.mean(axis=1)
    gc = np.stack(
        [_trilinear(grad[..., d], centroids) for d in range(3)], axis=-1
    )
    nrm = np.cross(tri_pts[:, 1] - tri_pts[:, 0], tri_pts[:, 2] - tri_pts[:, 0])
    flip = np.einsum("fi,fi->f", nrm, gc) > 0
    faces[flip] = faces[flip][:, [0, 2, 1]]

    return verts.astype(np.float32), faces


def robust_grid_frame(pts3, grid: int, margin: float = 0.15):
    """(lo, scale) of the outlier-robust Poisson grid; cell size = 1/scale."""
    lo = np.percentile(pts3, 0.5, axis=0)
    hi = np.percentile(pts3, 99.5, axis=0)
    span = max(float(np.max(hi - lo)), 1e-6)
    lo = lo - margin * span
    scale = (grid - 1.0) / (span * (1.0 + 2.0 * margin))
    return lo, scale


def poisson_surface(
    points, normals, grid: int = 128, sigma: float = 1.5, margin: float = 0.15
) -> Mesh:
    """Reconstruct a closed surface mesh from confidence-weighted oriented points.

    points: (N, 4) homogeneous or (N, 3); normals: (N, 3). Returns a Mesh with
    homogeneous vertices (w=1) and outward-oriented int32 faces, mirroring
    poissonSurface (cgal_poisson.cpp:47, recon.hpp:37).
    """
    pts = np.asarray(points, dtype=np.float64)
    if pts.shape[1] == 4:
        pts = pts[:, :3] / pts[:, 3:4]
    nrm = np.asarray(normals, dtype=np.float32)
    if len(pts) == 0:
        return Mesh(np.zeros((0, 4), np.float32), np.zeros((0, 3), np.int32))

    # robust bbox: a handful of outlier points must not inflate the grid
    # until the real surface is sub-voxel (CGAL's adaptive refinement is
    # naturally robust to this; a uniform grid is not)
    lo, scale = robust_grid_frame(pts, grid, margin)

    chi = np.asarray(
        _indicator_grid(
            jnp.asarray(pts, jnp.float32),
            jnp.asarray(nrm, jnp.float32),
            jnp.ones(len(pts), jnp.float32),
            jnp.asarray(lo, jnp.float32),
            jnp.float32(scale),
            grid=grid,
            sigma=sigma,
        )
    )
    iso = float(np.mean(_trilinear(chi, (pts - lo) * scale)))
    verts_grid, faces = marching_tetrahedra(chi, iso)
    verts_world = verts_grid / scale + lo
    verts4 = np.concatenate(
        [verts_world, np.ones((len(verts_world), 1), np.float32)], axis=1
    ).astype(np.float32)
    return Mesh(verts4, faces)
