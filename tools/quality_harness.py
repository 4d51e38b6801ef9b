"""Mesh-quality harness: ground-truth error metrics on synthetic scenes.

Runs the full pipeline on scenes whose geometry is known analytically — the
synthetic fixtures are ray-traced from fitted primitives (io/synthetic.py),
so the primitive IS the ground truth — and reports per-configuration
surface error: the quantitative counterpart of BASELINE.json's "meshes
matching CPU reference" criterion while the reference's sample videos are
unavailable.

Multi-scene: every preset is validated on THREE
geometries, not one sphere — koule-tr (sphere), koberec- (bounded plane,
carpet-like; the reference's Makefile demo scene, Makefile:43-45) and
zatisi (still-life arc, sphere-fit fixture). The metric follows the
fixture's auto-resolved mode:

  sphere: | |v - center| - radius | / radius      (all vertices)
  plane:  | (v - pc) . n | / radius               (vertices within the
          rendered extent; outside is background, not surface)

Exits nonzero when any scene's default-config median exceeds its
regression bound (--tolerance scales all bounds).

Usage: python tools/quality_harness.py [--scenes koule-tr,koberec-,zatisi]
       [--scale 8] [--configs default,trim-ens2]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def scene_truth(track):
    """(mode, params) for the fixture synthetic_frames(mode='auto') renders."""
    from meshrecon.io.synthetic import fit_sphere, fit_plane

    center, radius = fit_sphere(track.bundles)
    pc, pn, resid = fit_plane(track.bundles)
    if resid < 0.2 * radius:
        p3 = track.bundles[:, :3] / track.bundles[:, 3:4]
        extent = 1.3 * float(np.max(np.linalg.norm(p3 - pc, axis=1)))
        return "plane", (pc, pn, extent, radius)
    return "sphere", (center, radius)


def surface_error(mesh, mode, params):
    """(median, p90) relative surface error of mesh vertices vs the truth."""
    v3 = mesh.vertices[:, :3] / mesh.vertices[:, 3:4]
    if mode == "plane":
        pc, pn, extent, radius = params
        inside = np.linalg.norm(v3 - pc, axis=1) < extent
        if not inside.any():
            return float("inf"), float("inf")
        err = np.abs((v3[inside] - pc) @ pn) / radius
    else:
        center, radius = params
        err = np.abs(np.linalg.norm(v3 - center, axis=1) - radius) / radius
    return float(np.median(err)), float(np.percentile(err, 90))


CONFIGS = {
    "default": {},
    "exact": {"sampling": "exact"},
    "plane-sweep": {"depth_mode": "plane-sweep", "sweep_depths": 48},
    "farneback": {"use_farneback": True},
    "n3": {"iteration_count": 3},
    "n2": {"iteration_count": 2},
    "smooth": {"poisson_sigma": 2.5},
    "grid96": {"poisson_grid": 96},
    # the CLI default: plane-sweep bootstrap, then flow refinement
    "hybrid": {"depth_mode": "hybrid", "iteration_count": 2,
               "sweep_depths": 48},
    "hybrid-n3": {"depth_mode": "hybrid", "iteration_count": 3,
                  "sweep_depths": 48},
    # support-distance trim of the hallucinated Poisson closure — the
    # round-3 flagship quality lever (med 7x, p90 10x at 1/8 res)
    "trim": {"depth_mode": "hybrid", "iteration_count": 2,
             "sweep_depths": 48, "poisson_trim": 2.0},
    "trim-sp2": {"depth_mode": "hybrid", "iteration_count": 2,
                 "sweep_depths": 48, "poisson_trim": 2.0,
                 "sweep_passes": 2},
    # union of two independent camera draws, meshed once
    "trim-ens2": {"depth_mode": "hybrid", "iteration_count": 2,
                  "sweep_depths": 48, "poisson_trim": 2.0,
                  "ensemble_seeds": (3, 13)},
    # the flagship `--preset quality` bundle (pipeline/config.py:547-556):
    # 3-draw seed-ensemble union + 3 consensus-trim rounds on the default
    # support trim. Gated below with its own per-scene bounds so the
    # flagship claim has a regression bound.
    "quality": {"depth_mode": "hybrid", "iteration_count": 2,
                "sweep_depths": 48, "poisson_trim": 2.0,
                "consensus_rounds": 3, "ensemble_seeds": (3, 13, 23)},
    # flow gate rows: lv2+w1 became the pipeline default after the gates
    # in BASELINE.md "lv2 flow-pyramid gate"; lv3w2 restores the older
    # config for regression A/Bs
    "lv3w2": {"flow_levels": 3, "flow_warps": 2},
    # taylor variance gate: the first-order re-warp eliminates the
    # bicubic re-gather (BASELINE.md "taylor variance gate")
    "taylor": {"variance_mode": "taylor"},
    # explicit-rewarp controls: after the round-5 taylor default flip the
    # bare "default"/"quality" rows measure taylor, so A/Bs must pin the
    # rewarp side explicitly (a bare default row can also be poisoned by
    # whatever MESHRECON_VARIANCE the process imported under)
    "rewarp": {"variance_mode": "rewarp"},
    "quality-rewarp": {"depth_mode": "hybrid", "iteration_count": 2,
                       "sweep_depths": 48, "poisson_trim": 2.0,
                       "consensus_rounds": 3, "ensemble_seeds": (3, 13, 23),
                       "variance_mode": "rewarp"},
    "quality-taylor": {"depth_mode": "hybrid", "iteration_count": 2,
                       "sweep_depths": 48, "poisson_trim": 2.0,
                       "consensus_rounds": 3, "ensemble_seeds": (3, 13, 23),
                       "variance_mode": "taylor"},
}

# Default-config regression bounds on the MEDIAN at --scale 8 (measured
# before the port to the GPU, post-tie-slop + taylor default: koule 0.113,
# koberec- 0.049, zatisi 0.064 — the tie-slop fix's denser re-draw moved
# koule 0.082 -> 0.113, so its bound is re-set at ~2x the measurement like
# the others; --tolerance multiplies them). Generous vs measured so draw
# noise cannot flake the gate, tight enough to catch a regression.
SCENE_BOUNDS = {
    "koule-tr": 0.22,
    "koberec-": 0.12,
    "zatisi": 0.20,  # non-primitive still life approximated by a sphere
}

# Regression bounds for the flagship "quality" preset config at --scale 8
# (measured before the port to the GPU, AFTER the raster shared-edge
# tie-slop fix — the fix fills exact-tie interior holes in depth renders,
# which makes more probes servable and re-draws the camera policy (koule
# moved 4622 -> 16816 faces); seed 3 + draws (3,13,23): koule
# 0.0484/0.1403, koberec- 0.0088/0.0278, zatisi 0.0658/0.2157 med/p90;
# bounds ~2x measured so draw noise cannot flake the gate). Gated on BOTH
# median and p90 — the preset's claim is a tail claim. zatisi's preset
# p90 sits above its default config: the fixture's sphere fit only
# approximates the still-life arc, and the 3-draw union covers more of
# the non-spherical extremities — a metric artifact, bounded all the same.
QUALITY_BOUNDS = {
    "koule-tr": (0.097, 0.28),
    "koberec-": (0.020, 0.060),
    "zatisi": (0.13, 0.43),
}

# Per-scene config adjustments: koberec-/zatisi at 1/8 res leave the
# accumulate-to-threshold camera policy sub-threshold EVERYWHERE (the
# reference's thresholds scale with pixel counts the same way,
# heuristic.cpp:429-486) — the --min-bundles floor promotes the policy's
# own nearly-chosen pairs so the fixture is testable at small scale.
SCENE_KW = {
    "koberec-": {"min_bundles": 4},
    "zatisi": {"min_bundles": 4},
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", default="koule-tr,koberec-,zatisi")
    ap.add_argument("--scene", default=None,
                    help="single scene YAML path (legacy form)")
    ap.add_argument("--scale", type=int, default=8)
    ap.add_argument("--configs", default="default")
    ap.add_argument("--tolerance", type=float, default=1.0,
                    help="multiplier on the per-scene regression bounds")
    args = ap.parse_args(argv)

    from meshrecon.io.tracks import load_tracks
    from meshrecon.io.synthetic import synthetic_frames
    from meshrecon.pipeline.config import Config
    from meshrecon.pipeline.reconstruct import reconstruct

    scenes = ([args.scene.split("/")[-1].removesuffix(".yaml")]
              if args.scene else args.scenes.split(","))
    failed = []
    for scene in scenes:
        track = load_tracks(f"tracks/{scene}.yaml")
        w = track.width // args.scale
        h = track.height // args.scale
        frames = synthetic_frames(track, w, h, mode="auto", seed=0)
        mode, params = scene_truth(track)
        print(f"scene={scene} {w}x{h} mode={mode}", flush=True)
        print(f"{'config':<14}{'faces':>8}{'med_err/r':>11}{'p90_err/r':>11}"
              f"{'seconds':>9}", flush=True)
        for name in args.configs.split(","):
            # small-scale runs pin a coarse Poisson grid + single iteration
            # for CI speed; full/half-res runs use production defaults so
            # the numbers are comparable with seed_study rows
            kw = (dict(iteration_count=1, poisson_grid=64)
                  if args.scale >= 4 else {})
            kw.update(SCENE_KW.get(scene, {}))
            kw.update(CONFIGS[name])
            cfg = Config(track=track, frames=frames,
                         out_file_name=f"/tmp/quality_{scene}_{name}.obj",
                         seed=3, **kw)
            t0 = time.perf_counter()
            mesh = reconstruct(cfg)
            dt = time.perf_counter() - t0
            med, p90 = surface_error(mesh, mode, params)
            print(f"{name:<14}{len(mesh.faces):>8}{med:>11.4f}{p90:>11.4f}"
                  f"{dt:>9.1f}", flush=True)
            bound = SCENE_BOUNDS.get(scene, 0.3) * args.tolerance
            if name == "default" and med > bound:
                failed.append(f"{scene}: default med {med:.4f} > {bound}")
            if name == "quality":
                mb, pb = QUALITY_BOUNDS.get(scene, (0.3, 0.6))
                mb *= args.tolerance
                pb *= args.tolerance
                if med > mb:
                    failed.append(
                        f"{scene}: quality med {med:.4f} > {mb:.4f}")
                if p90 > pb:
                    failed.append(
                        f"{scene}: quality p90 {p90:.4f} > {pb:.4f}")
    for f in failed:
        print(f"FAIL {f}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
