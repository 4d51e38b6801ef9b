"""Binned z-buffer rasterizer for the GPU: a Pallas kernel on the Triton
route.

The XLA renderer (rasterizer.render_depth) tests every (pixel, triangle)
pair, so its cost is O(H*W*T) whatever the mesh covers. This kernel skips
the triangles that cannot touch a pixel tile:

  1. Renderer.load_mesh Morton-sorts the soup by world centroid once per
     mesh (rasterizer.morton_order), so CHUNK consecutive triangles are
     spatially coherent and their projected bounding boxes stay tight.
  2. XLA, per render: near-clip and screen setup (clip_project_planes), the
     affine edge coefficients (edge_affine_planes), and the screen bounding
     box of every chunk and of every GROUP of chunks.
  3. The kernel: one program per (camera, TILE_H x TILE_W pixel tile). It
     walks the groups, skips those whose box misses the tile, walks the
     chunks of a hit group the same way, and evaluates a hit chunk's
     triangles against all of the tile's pixels as one (CHUNK, pixels)
     block. The z-min stays in registers until the single store.

A pixel outside a triangle's box (grown by one pixel) is never covered by
it. render_depth has no such test, and for a near-degenerate triangle the
f32 cancellation in its huge edge coefficients can "cover" stray pixels far
away; there, and only there, the two renderers differ.

All cameras of a dispatch share one grid axis, so the B*(1+K) renders of a
fused update are one launch. Per pixel the contract is render_depth's
(render_glx.cpp:369-397 semantics): NDC depth, background 1.0, coverage by
the same tie-slopped affine edge functions (_coverage_z_planes).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from meshrecon.raster.rasterizer import clip_project_planes, edge_affine_planes

# Pixel tile of one program and triangle blocking, the fastest of the
# (tile, CHUNK, GROUP, warps) variants measured on an H100 at 640x480 with
# 4k-65k triangles (PERF.md). Triton blocks are powers of two.
TILE_H = 16
TILE_W = 16
CHUNK = 8  # triangles per coverage block (the unit of the chunk box test)
GROUP = 16  # chunks per group box: the walk tests T / (CHUNK * GROUP) boxes
NUM_WARPS = 4

_BIG = 3e38


def _raster_kernel(tri_ref, cbox_ref, gbox_ref, out_ref, *, height, width,
                   n_groups):
    """One (camera, pixel tile): z-min over the triangles whose chunk box
    overlaps the tile. tri_ref (N, 16, T): a0 b0 c0 a1 b1 c1 a2 b2 c2 z0 z1
    z2 xmin xmax ymin ymax planes; cbox_ref (N, 4, T/CHUNK) and gbox_ref
    (N, 4, T/(CHUNK*GROUP)): xmin xmax ymin ymax boxes."""
    n = pl.program_id(0)
    row0 = pl.program_id(1) * TILE_H
    col0 = pl.program_id(2) * TILE_W
    p = jax.lax.iota(jnp.int32, TILE_H * TILE_W)
    rows = (row0 + p // TILE_W).astype(jnp.float32)
    cols = (col0 + p % TILE_W).astype(jnp.float32)
    px = (cols - width / 2.0) * (2.0 / width)
    py = (height / 2.0 - rows) * (2.0 / height)
    x_lo = (col0.astype(jnp.float32) - width / 2.0) * (2.0 / width)
    x_hi = ((col0 + TILE_W - 1).astype(jnp.float32) - width / 2.0) * (
        2.0 / width)
    y_hi = (height / 2.0 - row0.astype(jnp.float32)) * (2.0 / height)
    y_lo = (height / 2.0 - (row0 + TILE_H - 1).astype(jnp.float32)) * (
        2.0 / height)

    def overlaps(box_ref, i):
        return ((box_ref[n, 0, i] <= x_hi) & (box_ref[n, 1, i] >= x_lo)
                & (box_ref[n, 2, i] <= y_hi) & (box_ref[n, 3, i] >= y_lo))

    def raster_chunk(ci, zbuf):
        f = [tri_ref[n, k, pl.ds(ci * CHUNK, CHUNK)] for k in range(16)]

        def lin(a, b, c):
            return a[:, None] * px[None, :] + b[:, None] * py[None, :] + c[
                :, None]

        l0 = lin(f[0], f[1], f[2])
        l1 = lin(f[3], f[4], f[5])
        l2 = lin(f[6], f[7], f[8])
        zs = l0 * f[9][:, None] + l1 * f[10][:, None] + l2 * f[11][:, None]
        covered = ((l0 >= 0) & (l1 >= 0) & (l2 >= 0)
                   & (zs >= -1.0) & (zs <= 1.0)
                   & (px[None, :] >= f[12][:, None])
                   & (px[None, :] <= f[13][:, None])
                   & (py[None, :] >= f[14][:, None])
                   & (py[None, :] <= f[15][:, None]))
        return jnp.minimum(
            zbuf, jnp.min(jnp.where(covered, zs, jnp.inf), axis=0))

    def group_body(gi, zbuf):
        def chunk_body(k, zbuf):
            ci = gi * GROUP + k
            return jax.lax.cond(overlaps(cbox_ref, ci),
                                lambda z: raster_chunk(ci, z),
                                lambda z: z, zbuf)

        return jax.lax.cond(overlaps(gbox_ref, gi),
                            lambda z: jax.lax.fori_loop(0, GROUP, chunk_body,
                                                        z),
                            lambda z: z, zbuf)

    zbuf = jax.lax.fori_loop(
        0, n_groups, group_body,
        jnp.full((TILE_H * TILE_W,), jnp.inf, jnp.float32))
    out_ref[...] = jnp.where(zbuf < jnp.inf, zbuf, 1.0)


def _box_min_max(box, size):
    """(N, 4, M) boxes -> (N, 4, M // size) boxes of each run of `size`."""
    n, _, m = box.shape
    b = box.reshape(n, 4, m // size, size)
    return jnp.stack([b[:, 0].min(-1), b[:, 1].max(-1), b[:, 2].min(-1),
                      b[:, 3].max(-1)], axis=1)


@functools.partial(jax.jit,
                   static_argnames=("height", "width", "interpret"))
def render_depth_binned(cameras, soup, soup_valid, height: int, width: int,
                        interpret: bool = False):
    """N depth renders of one soup: cameras (N, 4, 4) -> (N, H, W) NDC depth,
    background 1.0 — render_depth's contract for every camera.

    ``soup`` should be Morton-sorted (Renderer.load_mesh does this); an
    unsorted soup renders the same depths, only slower (looser chunk
    boxes). ``interpret`` runs the kernel in the Pallas interpreter (tests
    on the CPU)."""
    cameras = jnp.asarray(cameras, jnp.float32)
    planes = jax.vmap(lambda c: clip_project_planes(c, soup, soup_valid))(
        cameras)
    x0, x1, x2, y0, y1, y2, z0, z1, z2, _, ok = planes
    coeffs = edge_affine_planes(*planes)
    n, t = x0.shape
    pad = (-t) % (CHUNK * GROUP)

    # Screen boxes grown by one pixel: the tie slop lets coverage reach
    # EDGE_TIE_SLOP past an edge (further at a sliver's tip), and a box test
    # that cut it off would drop pixels render_depth covers.
    mx, my = 2.0 / width, 2.0 / height
    box = jnp.stack([
        jnp.where(ok, jnp.minimum(jnp.minimum(x0, x1), x2) - mx, _BIG),
        jnp.where(ok, jnp.maximum(jnp.maximum(x0, x1), x2) + mx, -_BIG),
        jnp.where(ok, jnp.minimum(jnp.minimum(y0, y1), y2) - my, _BIG),
        jnp.where(ok, jnp.maximum(jnp.maximum(y0, y1), y2) + my, -_BIG),
    ], axis=1)
    box = jnp.concatenate(
        [box, jnp.broadcast_to(jnp.asarray([_BIG, -_BIG, _BIG, -_BIG],
                                           jnp.float32)[None, :, None],
                               (n, 4, pad))], axis=2)
    cbox = _box_min_max(box, CHUNK)
    gbox = _box_min_max(cbox, GROUP)
    # padded triangles carry the empty box, which no pixel is inside
    tri = jnp.concatenate(
        [jnp.pad(jnp.stack(list(coeffs) + [z0, z1, z2], axis=1),
                 ((0, 0), (0, 0), (0, pad))), box], axis=1)

    nty = -(-height // TILE_H)
    ntx = -(-width // TILE_W)
    tile_px = TILE_H * TILE_W
    out = pl.pallas_call(
        functools.partial(_raster_kernel, height=float(height),
                          width=float(width), n_groups=gbox.shape[2]),
        grid=(n, nty, ntx),
        in_specs=[pl.no_block_spec] * 3,
        out_specs=pl.BlockSpec((None, None, None, tile_px),
                               lambda c, i, j: (c, i, j, 0)),
        out_shape=jax.ShapeDtypeStruct((n, nty, ntx, tile_px), jnp.float32),
        compiler_params=pl_triton.CompilerParams(num_warps=NUM_WARPS,
                                                 num_stages=1),
        backend="triton",
        interpret=interpret,
        name="binned_depth_raster",
    )(tri, cbox, gbox)
    out = out.reshape(n, nty, ntx, TILE_H, TILE_W).transpose(0, 1, 3, 2, 4)
    return out.reshape(n, nty * TILE_H, ntx * TILE_W)[:, :height, :width]
