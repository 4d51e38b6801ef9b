"""E2E quality cost of the flow sweep count (MESHRECON_FLOW_ITERS A/B).

The Chebyshev solver's accelerated sweeps are the arithmetic core of the
flow solve; dropping sweeps is a flow-perf lever IF the e2e geometry
survives. Quality is hardware-independent, so this study runs on the CPU at
1/8 res (80x60 koule); the wall-time payoff is measured on the GPU via
MESHRECON_FLOW_ITERS in a bench run.

Usage: python tools/iters_study.py [--iters 20,14,12] [--seeds 3,4,5]
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", default="20,14,12")
    ap.add_argument("--seeds", default="3,4,5")
    ap.add_argument("--scale", type=int, default=8)
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")  # a quality study

    import numpy as np

    from meshrecon.flow import variational
    from meshrecon.io.tracks import load_tracks
    from meshrecon.io.synthetic import synthetic_frames, fit_sphere
    from meshrecon.pipeline.config import Config
    from meshrecon.pipeline.reconstruct import reconstruct

    track = load_tracks("tracks/koule-tr.yaml")
    w, h = track.width // args.scale, track.height // args.scale
    frames = synthetic_frames(track, w, h, mode="sphere", seed=0)
    center, radius = fit_sphere(track.bundles)

    print(f"# koule {w}x{h}, n=2 hybrid trim2, radius {radius:.3f}",
          flush=True)
    print(f"{'iters':<7}{'seed':>5}{'med/r':>9}{'p90/r':>9}{'wall s':>8}",
          flush=True)
    for iters in (int(s) for s in args.iters.split(",")):
        variational._FLOW_ITERS = iters
        jax.clear_caches()  # the global is read at trace time
        for seed in (int(s) for s in args.seeds.split(",")):
            cfg = Config(track=track, frames=frames, seed=seed,
                         iteration_count=2, depth_mode="hybrid",
                         poisson_trim=2.0, poisson_grid=64,
                         out_file_name=f"/tmp/iters_{iters}_{seed}.obj")
            t0 = time.perf_counter()
            mesh = reconstruct(cfg)
            dt = time.perf_counter() - t0
            v3 = mesh.vertices[:, :3] / mesh.vertices[:, 3:4]
            err = np.abs(np.linalg.norm(v3 - center, axis=1) - radius)
            print(f"{iters:<7}{seed:>5}{np.median(err) / radius:>9.4f}"
                  f"{np.percentile(err, 90) / radius:>9.4f}{dt:>8.1f}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
