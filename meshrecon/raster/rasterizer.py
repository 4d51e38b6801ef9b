"""Software z-buffer rasterizer, the replacement for the reference's
off-screen OpenGL renderer (render_glx.cpp).

Design: instead of a GL state machine with per-call uploads/readbacks, the
mesh lives in HBM as a padded clip-space-ready triangle soup and every render
is one jitted function. Depth maps hold NDC z in [-1, 1] with background
pixels = 1.0 (``render_glx.cpp:395`` remaps the GL z-buffer by ``2z-1``;
``recon.hpp:30`` defines the sentinel).

Pixel <-> NDC convention: the sample position of pixel (row, col) is
``x = (col - W/2) * 2/W``, ``y = (H/2 - row) * 2/H`` — the exact positions at
which every consumer of depth maps in the pipeline reads them
(util.cpp:185-188). This differs from GL's half-pixel-center sampling by a
constant half-pixel shift but keeps the whole framework self-consistent.

Camera-facing entry points:

- :func:`render_depth` — full (H, W) depth image for the hot loop
  (recon.cpp:70) and for shadow maps (render_glx.cpp:272-328).
- :func:`depth_probe` — depth at a sparse set of NDC sample points. The
  reference renders a *full* frame per heuristic shot and reads back a handful
  of pixels (heuristic.cpp:456, 307-313); here that becomes a batched
  point-vs-triangle test, turning 200 full renders per iteration into one
  einsum-shaped reduction.
- :func:`render_depths` — N cameras of one soup, through the engine that
  :func:`raster_engine` picks for the backend: the binned Triton kernel
  (raster/binned.py) on a GPU, :func:`render_depth` elsewhere.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from meshrecon.io.obj import Mesh

_W_EPS = 1e-6  # near clip: keep fragments with clip w >= _W_EPS


def _lerp_vertex(a, b, t):
    return a + (b - a) * t[..., None]


def clip_triangles_near(tri_clip):
    """Clip clip-space triangles against the plane ``w = _W_EPS``.

    tri_clip: (T, 3, 4). Returns (tri_out, valid): (T, 2, 3, 4) and (T, 2).
    Each input triangle yields at most two output triangles (the quad case
    when exactly one vertex is behind the camera). Replaces the implicit
    near-plane clipping GL performs before z-buffering; required because
    heuristic probe cameras sit directly on the scene surface with
    near = 0.001 (heuristic.cpp:239), so many triangles straddle w = 0.
    """
    tri_clip = jnp.asarray(tri_clip)

    def clip_one(v):  # v: (3, 4)
        w = v[:, 3]
        inside = w >= _W_EPS
        n_in = jnp.sum(inside.astype(jnp.int32))

        # Rotate vertex order so the pattern is canonical: for n_in == 1 the
        # inside vertex is first; for n_in == 2 the outside vertex is last.
        def rotate(v, k):
            return jnp.roll(v, -k, axis=0)

        # index of the single inside vertex / single outside vertex
        first_in = jnp.argmax(inside)
        first_out = jnp.argmax(~inside)

        def isect(a, b):
            # point on segment a-b with w == _W_EPS
            t = (_W_EPS - a[3]) / (b[3] - a[3])
            return a + (b - a) * t

        def case0(v):
            z = jnp.zeros((2, 3, 4), v.dtype)
            return z, jnp.array([False, False])

        def case1(v):
            r = rotate(v, first_in)  # a inside, b, c outside
            a, b, c = r[0], r[1], r[2]
            t1 = jnp.stack([a, isect(a, b), isect(a, c)])
            return jnp.stack([t1, t1]), jnp.array([True, False])

        def case2(v):
            # rotate so the outside vertex is last: a, b inside, c outside
            r = rotate(v, (first_out + 1) % 3)
            a, b, c = r[0], r[1], r[2]
            ibc = isect(b, c)
            iac = isect(a, c)
            t1 = jnp.stack([a, b, ibc])
            t2 = jnp.stack([a, ibc, iac])
            return jnp.stack([t1, t2]), jnp.array([True, True])

        def case3(v):
            t1 = v
            return jnp.stack([t1, t1]), jnp.array([True, False])

        return jax.lax.switch(n_in, [case0, case1, case2, case3], v)

    tris, valid = jax.vmap(clip_one)(tri_clip)
    return tris, valid


# Shared-edge tie slop, in NDC units: a sample point lying EXACTLY on an
# edge shared by two triangles must be covered by at least one of them (GL
# guarantees exactly one via exact integer arithmetic + the top-left
# rule). Our f32 edge functions evaluate ~ulp-level noise at such ties and
# both triangles can round negative — measured on the axis-aligned plane
# fixture: 45 of 53 diagonal sample points holed at 96x128 (the synthetic
# scenes' symmetric geometry makes exact hits common; real meshes hit them
# rarely but nonzero). Each edge's plane constant is biased by
# EDGE_TIE_SLOP * |grad l| — i.e. coverage extends a fixed 6.25e-5 NDC
# units (0.02 px at 640-wide) past every edge REGARDLESS of triangle size.
# (A first cut using a fixed slop on the normalized barycentric extended
# near-clipped screen-spanning triangles by ~0.5 px into steep-z territory
# and corrupted the near-straddle depth test.) Shared edges then
# double-cover, which the z-buffer min resolves to the same interpolated z
# from either side; the bias is baked into the affine C coefficients so
# the per-pixel coverage test stays l >= 0.
EDGE_TIE_SLOP = 6.25e-5


def _edge(ax, ay, bx, by, px, py):
    """Signed area*2 of triangle (a, b, p); broadcasts over p."""
    return (bx - ax) * (py - ay) - (by - ay) * (px - ax)


def clip_project_planes(camera, soup, soup_valid):
    """World soup -> near-clipped, perspective-divided screen triangles, as
    FLAT per-component planes.

    camera: (4, 4); soup: (T, 3, 3); soup_valid: (T,).
    Returns (x0, x1, x2, y0, y1, y2, z0, z1, z2, area, ok), each (2T,)
    (slot-interleaved: a straddling triangle's two clip outputs stay
    adjacent, preserving the Morton coherence of a sorted soup).

    Same semantics as clip_triangles_near + _setup_screen, re-expressed
    entirely on 1-D component planes, so a camera batch is a plain (N, 2T)
    elementwise program.
    """
    camera = jnp.asarray(camera, jnp.float32)
    soup = jnp.asarray(soup, jnp.float32)

    # per-vertex clip components as planes: c_r = cam[r, :3] . p + cam[r, 3].
    # Written as fixed-association elementwise FMAs, NOT jnp.dot: under
    # jax.vmap (the camera-batched binned wrapper) a dot lowers to a batched
    # contraction whose accumulation order differs from the single-camera
    # lowering, and a ~1e-5 vertex perturbation can flip an edge test at a
    # silhouette pixel (a 0.245 depth difference was seen). Elementwise
    # mul/add broadcast identically under vmap, so batched == single bitwise.
    def clip_comp(row, v):
        p = soup[:, v, :]  # (T, 3) — sliced once; everything after is (T,)
        return (
            p[:, 0] * camera[row, 0] + p[:, 1] * camera[row, 1]
            + p[:, 2] * camera[row, 2] + camera[row, 3]
        )

    cx = [clip_comp(0, v) for v in range(3)]
    cy = [clip_comp(1, v) for v in range(3)]
    cz = [clip_comp(2, v) for v in range(3)]
    cw = [clip_comp(3, v) for v in range(3)]

    ins = [w >= _W_EPS for w in cw]
    n_in = (ins[0].astype(jnp.int32) + ins[1].astype(jnp.int32)
            + ins[2].astype(jnp.int32))
    # canonical rotation (clip_triangles_near semantics): n_in == 1 puts the
    # inside vertex first; n_in == 2 puts the outside vertex last
    first_in = jnp.where(ins[0], 0, jnp.where(ins[1], 1, 2))
    first_out = jnp.where(~ins[0], 0, jnp.where(~ins[1], 1, 2))
    k = jnp.where(n_in == 1, first_in,
                  jnp.where(n_in == 2, (first_out + 1) % 3, 0))

    def rot(comps, j):
        """comps[(j + k) % 3] per triangle, on planes."""
        idx = (k + j) % 3
        return jnp.where(idx == 0, comps[0],
                         jnp.where(idx == 1, comps[1], comps[2]))

    A = [rot(c, 0) for c in (cx, cy, cz, cw)]
    B = [rot(c, 1) for c in (cx, cy, cz, cw)]
    C = [rot(c, 2) for c in (cx, cy, cz, cw)]

    def isect(p, q):
        t = (_W_EPS - p[3]) / (q[3] - p[3])
        return [p[i] + (q[i] - p[i]) * t for i in range(4)]

    iAB = isect(A, B)
    iAC = isect(A, C)
    iBC = isect(B, C)

    one = n_in == 1
    two = n_in == 2
    three = n_in == 3

    def pick(c1, c2, c3):
        """per-component case select (case0 output is masked by ok)."""
        return jnp.where(one, c1, jnp.where(two, c2, c3))

    # slot 1: case1 (A, iAB, iAC); case2 (A, B, iBC); case3 original (use
    # the rotated verts: k == 0 there, so A,B,C ARE the original order)
    s1 = [[pick(A[i], A[i], A[i]) for i in range(4)],
          [pick(iAB[i], B[i], B[i]) for i in range(4)],
          [pick(iAC[i], iBC[i], C[i]) for i in range(4)]]
    # slot 2: only case2 (A, iBC, iAC); invalid otherwise
    s2 = [[A[i] for i in range(4)],
          [iBC[i] for i in range(4)],
          [iAC[i] for i in range(4)]]
    valid1 = (n_in >= 1) & jnp.asarray(soup_valid)
    valid2 = two & jnp.asarray(soup_valid)

    def screen(slot, valid):
        xs, ys, zs = [], [], []
        for v in range(3):
            w = slot[v][3]
            safe_w = jnp.where(jnp.abs(w) < _W_EPS, _W_EPS, w)
            xs.append(slot[v][0] / safe_w)
            ys.append(slot[v][1] / safe_w)
            zs.append(slot[v][2] / safe_w)
        area = _edge(xs[0], ys[0], xs[1], ys[1], xs[2], ys[2])
        ok = valid & (jnp.abs(area) > 1e-12)
        return xs, ys, zs, area, ok

    x1s, y1s, z1s, a1, ok1 = screen(s1, valid1)
    x2s, y2s, z2s, a2, ok2 = screen(s2, valid2)

    def inter(p, q):
        """slot-interleave two (T,) planes -> (2T,)."""
        return jnp.stack([p, q], axis=1).reshape(-1)

    return (
        inter(x1s[0], x2s[0]), inter(x1s[1], x2s[1]), inter(x1s[2], x2s[2]),
        inter(y1s[0], y2s[0]), inter(y1s[1], y2s[1]), inter(y1s[2], y2s[2]),
        inter(z1s[0], z2s[0]), inter(z1s[1], z2s[1]), inter(z1s[2], z2s[2]),
        inter(a1, a2), inter(ok1, ok2),
    )


def edge_affine_planes(x0, x1, x2, y0, y1, y2, z0, z1, z2, area, ok):
    """Per-triangle AFFINE barycentric coefficients: the normalized edge
    functions are ``l_i(p) = A_i*px + B_i*py + C_i`` — two FMAs per edge per
    pixel instead of re-deriving the vertex differences at every sample
    (the factored edge form costs ~2x the arithmetic in the binned kernel's
    coverage block). Coefficients carry the 1/area normalization;
    INVALID triangles get (A0, B0, C0) = (0, 0, -1) so l0 < 0 everywhere —
    coverage needs no separate validity operand.

    Returns (a0, b0, c0, a1, b1, c1, a2, b2, c2), each (T,). z at a covered
    pixel is ``l0*z0 + l1*z1 + l2*z2`` exactly as before.
    """
    inv_area = jnp.where(ok & (jnp.abs(area) > 1e-12), 1.0 / area, 0.0)

    def edge_coeffs(ax, ay, bx, by):
        # edge (a -> b): e(p) = (bx-ax)(py-ay) - (by-ay)(px-ax)
        dx = bx - ax
        dy = by - ay
        a = -dy * inv_area
        b = dx * inv_area
        c = (dy * ax - dx * ay) * inv_area
        # bake the tie slop into the plane constant: l >= 0 then accepts
        # true l >= -slop_px * |grad l| (see EDGE_TIE_SLOP_PX above)
        c = c + EDGE_TIE_SLOP * jnp.sqrt(a * a + b * b)
        return a, b, c

    a0, b0, c0 = edge_coeffs(x1, y1, x2, y2)
    a1, b1, c1 = edge_coeffs(x2, y2, x0, y0)
    a2, b2, c2 = edge_coeffs(x0, y0, x1, y1)
    bad = ~ok
    zero = jnp.zeros_like(c0)
    a0 = jnp.where(bad, zero, a0)
    b0 = jnp.where(bad, zero, b0)
    c0 = jnp.where(bad, -jnp.ones_like(c0), c0)
    return a0, b0, c0, a1, b1, c1, a2, b2, c2


def _coverage_z_planes(x0, x1, x2, y0, y1, y2, z0, z1, z2, area, ok, px, py):
    """Plane-layout variant of _coverage_z: all triangle data (T,) planes.
    Evaluates the SAME affine coefficients the binned kernel consumes
    (edge_affine_planes), so the two raster paths stay numerically aligned
    at coverage boundaries."""
    (a0, b0, c0, a1, b1, c1, a2, b2, c2) = edge_affine_planes(
        x0, x1, x2, y0, y1, y2, z0, z1, z2, area, ok)

    def lin(a, b, c):
        return a[:, None] * px + b[:, None] * py + c[:, None]

    l0 = lin(a0, b0, c0)
    l1 = lin(a1, b1, c1)
    l2 = lin(a2, b2, c2)
    covered = (l0 >= 0) & (l1 >= 0) & (l2 >= 0)
    zs = l0 * z0[:, None] + l1 * z1[:, None] + l2 * z2[:, None]
    covered &= (zs >= -1.0) & (zs <= 1.0)
    return jnp.where(covered, zs, jnp.inf)


def _setup_screen(tri_clip, valid):
    """Perspective-divide clipped triangles and precompute raster data.

    Returns dict of per-triangle arrays: ndc xy (T,3,2), z (T,3), bbox, and
    validity (degenerate triangles masked).
    """
    w = tri_clip[..., 3]
    safe_w = jnp.where(jnp.abs(w) < _W_EPS, _W_EPS, w)
    ndc = tri_clip[..., :3] / safe_w[..., None]
    x, y, z = ndc[..., 0], ndc[..., 1], ndc[..., 2]
    area = _edge(x[..., 0], y[..., 0], x[..., 1], y[..., 1], x[..., 2], y[..., 2])
    ok = valid & (jnp.abs(area) > 1e-12)
    bbox = (
        jnp.min(x, axis=-1),
        jnp.max(x, axis=-1),
        jnp.min(y, axis=-1),
        jnp.max(y, axis=-1),
    )
    return x, y, z, area, ok, bbox


def _coverage_z(x, y, z, area, ok, px, py):
    """z at sample points for one batch of triangles; +inf where uncovered.

    x, y, z: (T, 3); px, py: (..., P). Returns (T, ..., P) z or +inf.
    """
    # barycentric via edge functions, normalized by signed area (handles both
    # windings; GL renders both since the reference never enables culling)
    e0 = _edge(x[:, 1, None], y[:, 1, None], x[:, 2, None], y[:, 2, None], px, py)
    e1 = _edge(x[:, 2, None], y[:, 2, None], x[:, 0, None], y[:, 0, None], px, py)
    e2 = _edge(x[:, 0, None], y[:, 0, None], x[:, 1, None], y[:, 1, None], px, py)
    inv_area = 1.0 / area
    l0 = e0 * inv_area[:, None]
    l1 = e1 * inv_area[:, None]
    l2 = e2 * inv_area[:, None]
    # per-edge tie slop (|grad l_i| = |edge_i| / |area|, NDC units),
    # matching edge_affine_planes' biased C coefficients at the boundaries

    def slop(ax, ay, bx, by):
        return (EDGE_TIE_SLOP * jnp.abs(inv_area)
                * jnp.hypot(bx - ax, by - ay))[:, None]

    covered = ((l0 >= -slop(x[:, 1], y[:, 1], x[:, 2], y[:, 2]))
               & (l1 >= -slop(x[:, 2], y[:, 2], x[:, 0], y[:, 0]))
               & (l2 >= -slop(x[:, 0], y[:, 0], x[:, 1], y[:, 1]))
               & ok[:, None])
    zs = l0 * z[:, 0, None] + l1 * z[:, 1, None] + l2 * z[:, 2, None]
    # GL also clips fragments to the [-1, 1] depth range
    covered &= (zs >= -1.0) & (zs <= 1.0)
    return jnp.where(covered, zs, jnp.inf)


@functools.partial(jax.jit, static_argnames=("height", "width", "chunk"))
def render_depth(camera, soup, soup_valid, height, width, chunk=64):
    """Full-frame z-buffer depth render.

    camera: (4, 4); soup: (T, 3, 3) world triangles; soup_valid: (T,) bool.
    Returns (H, W) float32 NDC depth, background = 1.0.
    Functional equivalent of RenderGLX::depth (render_glx.cpp:369-397).
    """
    planes = clip_project_planes(camera, soup, soup_valid)

    cols = (jnp.arange(width, dtype=jnp.float32) - width / 2.0) * (2.0 / width)
    rows = (height / 2.0 - jnp.arange(height, dtype=jnp.float32)) * (2.0 / height)
    px = jnp.broadcast_to(cols[None, :], (height, width)).reshape(-1)
    py = jnp.broadcast_to(rows[:, None], (height, width)).reshape(-1)

    T = planes[0].shape[0]
    pad = (-T) % chunk
    padded = tuple(jnp.pad(a, (0, pad)) for a in planes)
    n_chunks = padded[0].shape[0] // chunk

    def body(zbuf, args):
        zc = _coverage_z_planes(*args, px[None, :], py[None, :])
        return jnp.minimum(zbuf, jnp.min(zc, axis=0)), None

    init = jnp.full((height * width,), jnp.inf, jnp.float32)
    args = tuple(a.reshape(n_chunks, chunk) for a in padded)
    zbuf, _ = jax.lax.scan(body, init, args)
    zbuf = jnp.where(jnp.isfinite(zbuf), zbuf, 1.0)
    return zbuf.reshape(height, width)


@functools.partial(jax.jit, static_argnames=("chunk",))
def depth_probe(cameras, soup, soup_valid, sample_xy, chunk=128):
    """Depth at sparse NDC sample points for a batch of viewer cameras.

    cameras: (S, 4, 4); soup: (T, 3, 3); sample_xy: (S, N, 2) NDC positions.
    Returns (S, N) NDC depth with background 1.0. This is the batched
    replacement for the heuristic's 200 per-shot depth renders
    (heuristic.cpp:448-456): only the sample positions that are actually read
    are ever computed.

    Viewers are processed SEQUENTIALLY (lax.map): each shot's clipped
    triangle setup is O(T) memory, and vmapping it over 200 shots of a 16k-
    triangle mesh materializes ~20 GB.
    """
    cameras = jnp.asarray(cameras, jnp.float32)
    soup = jnp.asarray(soup, jnp.float32)

    def probe_one(camera, xy):
        planes = clip_project_planes(camera, soup, soup_valid)
        T = planes[0].shape[0]
        pad = (-T) % chunk
        padded = tuple(jnp.pad(a, (0, pad)) for a in planes)
        n_chunks = padded[0].shape[0] // chunk

        def body(zmin, args):
            zc = _coverage_z_planes(*args, xy[None, :, 0], xy[None, :, 1])
            return jnp.minimum(zmin, jnp.min(zc, axis=0)), None

        init = jnp.full((xy.shape[0],), jnp.inf, jnp.float32)
        args = tuple(a.reshape(n_chunks, chunk) for a in padded)
        zmin, _ = jax.lax.scan(body, init, args)
        return jnp.where(jnp.isfinite(zmin), zmin, 1.0)

    return jax.lax.map(
        lambda cx: probe_one(cx[0], cx[1]),
        (cameras, jnp.asarray(sample_xy, jnp.float32)),
    )


def raster_engine() -> str:
    """The depth renderer for this process's default backend: "triton" (the
    binned kernel, raster/binned.py) on a GPU, "xla" (render_depth)
    elsewhere. The one place the choice is made; callers pass the result
    down as a static argument."""
    return "triton" if jax.default_backend() == "gpu" else "xla"


def render_depths(cameras, soup, soup_valid, height: int, width: int,
                  raster: str | None = None):
    """N depth renders of one soup: cameras (N, 4, 4) -> (N, H, W).

    raster: "triton", "xla", or None for :func:`raster_engine`'s choice.
    Traceable (the fused updates call it inside their programs)."""
    raster = raster or raster_engine()
    if raster == "triton":
        from meshrecon.raster.binned import render_depth_binned

        return render_depth_binned(cameras, soup, soup_valid, height, width)
    if raster != "xla":
        raise ValueError(f"raster engine must be triton|xla: {raster!r}")
    # one camera at a time: a vmapped brute render holds N x chunk x H x W
    # coverage values at once
    return jax.lax.map(
        lambda c: render_depth(c, soup, soup_valid, height, width),
        jnp.asarray(cameras, jnp.float32))


def morton_order(soup: np.ndarray) -> np.ndarray:
    """Host-side spatial sort: permutation ordering triangles by the Morton
    code of their centroid (10 bits/axis). Consecutive triangles of a sorted
    soup stay spatially close, which keeps the binned kernel's chunk boxes
    tight; every other consumer is order-independent (z-buffer min)."""
    soup = np.asarray(soup)
    cent = soup.mean(axis=1)  # (T, 3)
    lo = cent.min(axis=0)
    span = np.maximum(cent.max(axis=0) - lo, 1e-12)
    q = np.minimum(((cent - lo) / span * 1023.0).astype(np.uint64), 1023)

    def spread(v):
        v = (v | (v << 16)) & np.uint64(0x030000FF)
        v = (v | (v << 8)) & np.uint64(0x0300F00F)
        v = (v | (v << 4)) & np.uint64(0x030C30C3)
        v = (v | (v << 2)) & np.uint64(0x09249249)
        return v

    code = (spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1))
            | (spread(q[:, 2]) << np.uint64(2)))
    return np.argsort(code, kind="stable")


def _soup_capacity(t: int) -> int:
    """Capacity class for a t-triangle soup: the smallest power of 4 that is
    at least max(t, 256).

    The soup's capacity is a shape dimension of EVERY downstream program
    (renders, the camera policy's depth probe, the whole fused dense
    update), and each distinct capacity is a fresh compile. Powers of 4
    bound a run at the 65,536-face render cap to five capacities
    (256 ... 65,536) while padding at most 4x. Padded triangles are invalid:
    the binned kernel skips them by their empty boxes, the XLA path pays
    O(capacity) for them.
    """
    cap = 256
    while cap < t:
        cap *= 4
    return cap


class Renderer:
    """Pipeline-facing renderer, the seam the reference models as the abstract
    ``Render`` base (recon.hpp:93-100). Holds the mesh as a capacity-padded
    triangle soup so repeated renders across iterations reuse one compiled
    program per (H, W, capacity)."""

    def __init__(self, width: int, height: int):
        self.width = int(width)
        self.height = int(height)
        self._soup = None
        self._valid = None

    def load_mesh(self, mesh: Mesh) -> None:
        """Dehomogenize vertices into a triangle soup (render_glx.cpp:230-258).

        The soup is Morton-sorted by centroid so the binned kernel's chunk
        boxes stay tight (raster/binned.py); the sort is a pure permutation,
        invisible to every consumer (z-buffer min is order-independent)."""
        soup = np.asarray(mesh.triangle_soup, dtype=np.float32)
        t = soup.shape[0]
        if t:
            soup = soup[morton_order(soup)]
        cap = _soup_capacity(t)
        padded = np.zeros((cap, 3, 3), dtype=np.float32)
        padded[:t] = soup
        valid = np.zeros(cap, dtype=bool)
        valid[:t] = True
        self._soup = jnp.asarray(padded)
        self._valid = jnp.asarray(valid)

    @property
    def soup(self):
        return self._soup

    @property
    def soup_valid(self):
        return self._valid

    def depth(self, camera) -> jnp.ndarray:
        assert self._soup is not None, "load_mesh first"
        return render_depths(jnp.asarray(camera, jnp.float32)[None],
                             self._soup, self._valid, self.height,
                             self.width)[0]

    def depth_at(self, cameras, sample_xy) -> jnp.ndarray:
        assert self._soup is not None, "load_mesh first"
        return depth_probe(cameras, self._soup, self._valid, sample_xy)

    def projected(self, camera, frame, projector, depth_main=None):
        from meshrecon.raster.fragment import projected_image

        assert self._soup is not None, "load_mesh first"
        if depth_main is None:
            depth_main = self.depth(camera)
        depth_side = self.depth(projector)
        return projected_image(camera, depth_main, frame, projector, depth_side)
