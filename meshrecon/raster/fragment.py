"""Fragment stage: shadow-mapped projective texturing and background mixing.

The reference renders its prediction image with a two-pass GL pipeline
(render_glx.cpp:261-367 + shader.frag). Because the main-camera depth map
already determines the world position of every fragment
(``world = main_inv @ (x, y, z, 1)``, exactly the perspective-correct
interpolated ``pos`` the GLSL shader receives), the whole second pass
collapses into a per-pixel map over the depth image — no rasterization
needed: one dense elementwise pass with two gathers instead of a second
geometry pass.

Conventions replicated from shader.frag:

- shadow test: ``shadow_ndc + 0.01 > z_ndc_side`` (+0.01 NDC bias,
  shader.frag:17-18), using a 3x3 *max* dilated shadow map (the intent of the
  acne filter at render_glx.cpp:287-314).
- in-frustum test on side-camera NDC x, y (shader.frag:19).
- texture coordinate ``xy/(2w) - 0.5`` with REPEAT wrapping is algebraically
  ``(ndc+1)/2 (mod 1)`` — i.e. plain NDC-to-texture mapping (shader.frag:22).
- the result's red channel is intensity, green/blue the visibility mask
  (render_glx.cpp:358); we return (intensity, mask) directly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from meshrecon import BACKGROUND_DEPTH

_HI = jax.lax.Precision.HIGHEST


def dilate3x3_max(depth):
    """3x3 max dilation of a depth map (shadow-acne suppression)."""
    return jax.lax.reduce_window(
        depth,
        -jnp.inf,
        jax.lax.max,
        window_dimensions=(3, 3),
        window_strides=(1, 1),
        padding="SAME",
    )


def bilinear_sample(image, col, row):
    """Bilinear sample image (H, W) at continuous (col, row); clamped borders."""
    h, w = image.shape
    col = jnp.clip(col, 0.0, w - 1.0)
    row = jnp.clip(row, 0.0, h - 1.0)
    c0 = jnp.floor(col).astype(jnp.int32)
    r0 = jnp.floor(row).astype(jnp.int32)
    c1 = jnp.minimum(c0 + 1, w - 1)
    r1 = jnp.minimum(r0 + 1, h - 1)
    fc = col - c0
    fr = row - r0
    v00 = image[r0, c0]
    v01 = image[r0, c1]
    v10 = image[r1, c0]
    v11 = image[r1, c1]
    return (
        v00 * (1 - fr) * (1 - fc)
        + v01 * (1 - fr) * fc
        + v10 * fr * (1 - fc)
        + v11 * fr * fc
    )


def nearest_sample(image, col, row):
    # floor(x + 0.5): round half UP, GL_NEAREST's rule (banker's rounding
    # would send every other .5 tie the other way)
    h, w = image.shape
    c = jnp.clip(jnp.floor(col + 0.5).astype(jnp.int32), 0, w - 1)
    r = jnp.clip(jnp.floor(row + 0.5).astype(jnp.int32), 0, h - 1)
    return image[r, c]


@jax.jit
def projected_image(camera, depth_main, frame, projector, depth_side):
    """Reproject `frame` (seen by `projector`) into `camera`'s view.

    camera, projector: (4, 4); depth_main, depth_side: (H, W) NDC depth;
    frame: (H, W) grayscale (any float/int scale, passed through).
    Returns (intensity (H, W) float32, mask (H, W) bool). mask False where the
    fragment is shadowed, outside the projector frustum, or background.
    """
    h, w = depth_main.shape
    depth_main = jnp.asarray(depth_main, jnp.float32)
    frame = jnp.asarray(frame, jnp.float32)
    shadow = dilate3x3_max(jnp.asarray(depth_side, jnp.float32))

    cols = (jnp.arange(w, dtype=jnp.float32) - w / 2.0) * (2.0 / w)
    rows = (h / 2.0 - jnp.arange(h, dtype=jnp.float32)) * (2.0 / h)
    x = jnp.broadcast_to(cols[None, :], (h, w))
    y = jnp.broadcast_to(rows[:, None], (h, w))
    z = depth_main
    valid = z != BACKGROUND_DEPTH

    main_inv = jnp.linalg.inv(jnp.asarray(camera, jnp.float32))
    # NDC_main -> clip_side
    side = jnp.matmul(jnp.asarray(projector, jnp.float32), main_inv,
                      precision=_HI)

    # plane math: four (H, W) planes, no (H, W, 4) intermediate
    def apply_side(row):
        return side[row, 0] * x + side[row, 1] * y + side[row, 2] * z + side[row, 3]

    s0, s1, s2, sw = apply_side(0), apply_side(1), apply_side(2), apply_side(3)
    behind = sw <= 1e-6
    sw_safe = jnp.where(jnp.abs(sw) < 1e-6, 1e-6, sw)
    sx = s0 / sw_safe
    sy = s1 / sw_safe
    sz = s2 / sw_safe

    # NDC -> pixel with the framework's integer-grid convention (the inverse
    # of util.cpp:185-188); shadow lookup is nearest like the GL_NEAREST
    # shadow sampler
    scol = (sx + 1.0) * 0.5 * w
    srow = (1.0 - sy) * 0.5 * h
    inframe = (sx > -1.0) & (sx < 1.0) & (sy > -1.0) & (sy < 1.0) & ~behind

    shadow_z = nearest_sample(shadow, scol, srow)
    intensity = bilinear_sample(frame, scol, srow)
    visible = shadow_z + 0.01 > sz
    mask = valid & visible & inframe
    return jnp.where(mask, intensity, 0.0), mask


@jax.jit
def projected_image_batched(cam_mains, depth_mains, frames, projectors,
                            depth_sides):
    """Batched projective texturing: B main cameras x K sides in ONE pass.

    cam_mains: (B, 4, 4); depth_mains: (B, H, W); frames: (B, K, H, W);
    projectors: (B, K, 4, 4); depth_sides: (B, K, H, W).
    Returns (intensity (B, K, H, W), mask (B, K, H, W) bool).

    Same math as :func:`projected_image`: the two per-pixel sampling passes
    are one gather each over all B*K images and the shadow dilation is one
    batched reduce_window.
    """
    b, k, h, w = frames.shape
    depth_mains = jnp.asarray(depth_mains, jnp.float32)
    frames = jnp.asarray(frames, jnp.float32)
    shadow = jax.lax.reduce_window(
        jnp.asarray(depth_sides, jnp.float32), -jnp.inf, jax.lax.max,
        window_dimensions=(1, 1, 3, 3), window_strides=(1, 1, 1, 1),
        padding="SAME")

    cols = (jnp.arange(w, dtype=jnp.float32) - w / 2.0) * (2.0 / w)
    rows = (h / 2.0 - jnp.arange(h, dtype=jnp.float32)) * (2.0 / h)
    x = jnp.broadcast_to(cols[None, :], (h, w))
    y = jnp.broadcast_to(rows[:, None], (h, w))
    z = depth_mains[:, None]  # (B, 1, H, W)
    valid = z != BACKGROUND_DEPTH

    main_inv = jnp.linalg.inv(jnp.asarray(cam_mains, jnp.float32))
    side = jnp.einsum("bkij,bjl->bkil",
                      jnp.asarray(projectors, jnp.float32), main_inv,
                      precision=_HI)

    def apply_side(row):
        return (side[:, :, row, 0, None, None] * x
                + side[:, :, row, 1, None, None] * y
                + side[:, :, row, 2, None, None] * z
                + side[:, :, row, 3, None, None])

    s0, s1, s2, sw = apply_side(0), apply_side(1), apply_side(2), apply_side(3)
    behind = sw <= 1e-6
    sw_safe = jnp.where(jnp.abs(sw) < 1e-6, 1e-6, sw)
    sx = s0 / sw_safe
    sy = s1 / sw_safe
    sz = s2 / sw_safe

    scol = (sx + 1.0) * 0.5 * w
    srow = (1.0 - sy) * 0.5 * h
    inframe = (sx > -1.0) & (sx < 1.0) & (sy > -1.0) & (sy < 1.0) & ~behind

    shadow_z = jax.vmap(jax.vmap(nearest_sample))(shadow, scol, srow)
    intensity = jax.vmap(jax.vmap(bilinear_sample))(frames, scol, srow)
    visible = shadow_z + 0.01 > sz
    mask = valid & visible & inframe
    return jnp.where(mask, intensity, 0.0), mask


@jax.jit
def mix_background(intensity, mask, background, depth):
    """Fill invalid reprojected pixels from the main frame itself.

    Equivalent of util.cpp:366-387: where the raycast was undefined (mask
    False, i.e. the reference's G channel == 0) or the depth is background,
    take the original pixel and force depth to the background sentinel. The
    reference mutates `depth` in place; we return the new depth.

    Returns (mixed (H, W) float32, new_depth (H, W) float32).
    """
    background = jnp.asarray(background, jnp.float32)
    bad = (depth == BACKGROUND_DEPTH) | ~mask
    mixed = jnp.where(bad, background, intensity)
    new_depth = jnp.where(bad, BACKGROUND_DEPTH, depth)
    return mixed, new_depth
