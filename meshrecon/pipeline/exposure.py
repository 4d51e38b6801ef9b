"""Per-frame exposure estimation and normalization.

Vectorized re-implementation of Configuration::estimateExposure
(configuration.cpp:270-426): sample each sparse bundle's color from every
frame where the track is enabled (box average over a radius^2 = 16 circular
neighborhood, rejecting clipped 0/255 texels, configuration.cpp:299 +
util.cpp:408-433), then alternate between estimating per-point brightness and
per-frame, per-channel exposure gains (SVD least squares with 0.4
over-relaxation, configuration.cpp:345-392). Finally frames are collapsed to
grayscale as ``sum_c channel_c * exposure[c]`` (configuration.cpp:417-425).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from meshrecon.geometry.camera import project_points


def sample_box(image: np.ndarray, radius_sq: float, x: float, y: float,
               channel: int) -> float:
    """Box-average over a circular neighborhood; -1 when no usable texels.

    Rejects texels with value 0 or 255 (under/over-exposed), like
    util.cpp:408-433.
    """
    h, w = image.shape[:2]
    radius = np.sqrt(radius_sq)
    y0, y1 = int(max(0, y - radius)), int(min(y + radius + 1, h))
    x0, x1 = int(max(0, x - radius)), int(min(x + radius + 1, w))
    if y0 >= y1 or x0 >= x1:
        return -1.0
    patch = image[y0:y1, x0:x1, channel].astype(np.float64)
    yy, xx = np.mgrid[y0:y1, x0:x1]
    m = ((xx - x) ** 2 + (yy - y) ** 2 <= radius_sq) & (patch > 0) & (patch < 255)
    if not np.any(m):
        return -1.0
    return float(patch[m].mean())


def _solve_exposure_device(sampled, valid):
    """Alternating brightness/exposure solve ON DEVICE.

    Batched counterpart of the reference's per-frame loop
    (configuration.cpp:345-392): one jitted ``while_loop`` alternating
    (a) per-point brightness given exposure and (b) per-frame, per-channel
    exposure by masked least squares (rows of invalid samples are zeroed,
    which leaves the minimum-norm solution unchanged), with the same 0.4
    over-relaxation and the same mean-residual stopping rule (< 0.1, max
    100 iterations). All F frames solve as one vmapped SVD lstsq batch.

    sampled: (F, N, C) host array (-1 where unsampled); valid: (F, N) bool.
    Returns (exposure (C, F) np.float64, brightness (N,) np.float64).
    """
    s = np.where(valid[..., None], sampled, 0.0).astype(np.float32)
    exposure, brightness = _exposure_iterations(
        s, np.asarray(valid, np.float32))
    return (np.asarray(exposure, np.float64),
            np.asarray(brightness, np.float64))


@jax.jit
def _exposure_iterations(s, v):
    """The while_loop of _solve_exposure_device: s (F, N, C) samples with
    invalid rows zeroed, v (F, N) validity as float."""
    hi = jax.lax.Precision.HIGHEST
    f_count, p_count, ch = s.shape
    sum_brightness = jnp.sum(s) / ch
    wsum = jnp.sum(v, axis=0)
    nvalid = jnp.maximum(jnp.sum(v, axis=1), 1.0)  # per-frame sample count

    def step(carry):
        exposure, _bright, err, it = carry
        # (a) assume exposure correct -> per-point brightness
        per_fp = jnp.einsum("fpc,cf->fp", s, exposure, precision=hi)
        brightness = jnp.where(wsum > 0, jnp.sum(per_fp, axis=0)
                               / jnp.maximum(wsum, 1.0), 0.0)
        brightness = brightness * (sum_brightness
                                   / jnp.maximum(jnp.sum(per_fp), 1e-12))
        # (b) assume brightness correct -> per-frame exposure (lstsq)
        b = brightness[None, :] * v  # (F, N); zero rows match zeroed A rows
        sol = jax.vmap(lambda a_, b_: jnp.linalg.lstsq(a_, b_)[0])(s, b)
        omega = 0.4
        new = sol.T * (1 + omega) - exposure * omega  # (C, F)
        resid = jnp.einsum("fpc,cf->fp", s, new, precision=hi) - b
        err = jnp.mean(jnp.linalg.norm(resid, axis=1) / nvalid)
        return new, brightness, err, it + 1

    def cond(carry):
        _e, _b, err, it = carry
        return (err >= 0.1) & (it < 100)

    init = (jnp.full((ch, f_count), 1.0 / ch, jnp.float32),
            jnp.ones(p_count, jnp.float32), jnp.float32(jnp.inf),
            jnp.int32(0))
    exposure, brightness, _err, _it = jax.lax.while_loop(cond, step, init)
    return exposure, brightness


def estimate_exposure(frames, cameras, bundles, bundles_enabled, lens_distortion,
                      center_x, center_y, width, height, verbose=False,
                      dump_tab: bool = False):
    """Estimate exposure gains and return grayscale-normalized frames.

    frames: list/array of (H, W, 3) uint8 BGR frames; cameras: (F, 4, 4);
    bundles: (N, 4). Returns (gray_frames (F, H, W) float32, exposure (3, F)).
    """
    f_count = len(cameras)
    p_count = len(bundles)
    ch = frames[0].shape[2]
    aspect = float(height) / float(width)

    sampled = np.full((f_count, p_count, ch), -1.0)
    valid = np.zeros((f_count, p_count), bool)
    for i in range(f_count):
        ndc = np.asarray(
            project_points(cameras[i], bundles, lens_distortion, aspect)
        )
        for j in range(p_count):
            if i not in bundles_enabled[j]:
                continue
            img_x = center_x + ndc[j, 0] * width * 0.5
            img_y = height - center_y - ndc[j, 1] * height * 0.5
            vals = [sample_box(frames[i], 16.0, img_x, img_y, c) for c in range(ch)]
            if all(v >= 0 for v in vals):
                sampled[i, j] = vals
                valid[i, j] = True
        if valid[i].sum() < ch:
            raise RuntimeError(
                f"frame {i}: too few valid exposure samples "
                "(configuration.cpp:315-318 aborts here too)"
            )

    exposure, brightness = _solve_exposure_device(sampled, valid)

    if dump_tab:
        # exposure.tab: per frame the channel gains + residual stddev
        # (configuration.cpp:395-415)
        with open("exposure.tab", "w") as fh:
            for i in range(f_count):
                res = []
                for j in range(p_count):
                    if not valid[i, j]:
                        continue
                    for c in range(ch):
                        res.append(sampled[i, j, c]
                                   - exposure[c, i] * brightness[j])
                stddev = float(np.sqrt(np.mean(np.square(res)))) if res else 0.0
                gains = "\t".join(f"{exposure[c, i]:f}" for c in range(ch))
                fh.write(f"{gains}\t{stddev:f}\n")

    gray = np.zeros((f_count,) + frames[0].shape[:2], np.float32)
    for i in range(f_count):
        gray[i] = np.einsum("hwc,c->hw", frames[i].astype(np.float32),
                            exposure[:, i]).astype(np.float32)
    return np.clip(gray, 0, 255), exposure
