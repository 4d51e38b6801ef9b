"""End-to-end mesh quality vs flow-solver knobs, full-res koule scene.

Monkeypatches the fused update's flow call with each variant and runs one
flow-mode iteration of the real pipeline (synthetic sphere fixture frames,
known ground truth), reporting median/p90 surface error and wall time.

Usage: python tools/flow_e2e_quality.py [scale]
"""

from __future__ import annotations

import functools
import sys
import time

import numpy as np


def main():
    scale = int(sys.argv[1]) if len(sys.argv) > 1 else 1
    variants = {
        "base_i60_w2": dict(),
        "i30_w1": dict(iters=30, warps=1),
        "i45_w1": dict(iters=45, warps=1),
    }

    from meshrecon.io.tracks import load_tracks
    from meshrecon.io.synthetic import synthetic_frames, fit_sphere
    from meshrecon.pipeline.config import Config
    from meshrecon.pipeline import fused as F
    from meshrecon.pipeline.reconstruct import reconstruct
    from meshrecon.flow.variational import variational_flow

    track = load_tracks("tracks/koule-tr.yaml")
    w, h = track.width // scale, track.height // scale
    frames = synthetic_frames(track, w, h, mode="sphere", seed=0)
    center, radius = fit_sphere(track.bundles)
    orig = variational_flow

    for name, kw in variants.items():
        F.variational_flow = functools.partial(orig, **kw)
        # the fused step and the batched-step builder cache compiled
        # executables keyed only on shapes/statics — the monkeypatched flow
        # is baked in at trace time, so drop both caches per variant
        F.fused_main_update.clear_cache()
        from meshrecon.pipeline import reconstruct as R

        R._vmapped_step.cache_clear()
        cfg = Config(track=track, frames=frames, iteration_count=1,
                     depth_mode="flow", poisson_grid=96,
                     out_file_name=f"/tmp/fq_{name}.obj", seed=3)
        t0 = time.perf_counter()
        mesh = reconstruct(cfg)
        dt = time.perf_counter() - t0
        v3 = mesh.vertices[:, :3] / mesh.vertices[:, 3:4]
        err = np.abs(np.linalg.norm(v3 - center, axis=1) - radius)
        print(f"{name:<14} faces={len(mesh.faces):>7} "
              f"med={np.median(err)/radius:.4f} "
              f"p90={np.percentile(err, 90)/radius:.4f} {dt:7.1f}s",
              flush=True)
    F.variational_flow = orig


if __name__ == "__main__":
    main()
