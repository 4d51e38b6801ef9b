"""Runtime configuration: CLI parsing, scene ingestion, clip decoding.

Replicates the reference CLI exactly (configuration.cpp:37-123):

  recon [OPTIONS] [INPUT_FILE]
    -c, --camera-threshold=f   camera-selection threshold   (default 10)
    -e, --estimate-exposure    normalize exposure over time (default off)
    -f, --farneback            Farneback flow instead of variational
    -i, --input=s              input YAML scene file
    -k, --skip-frames=i        use every n-th frame         (default 1)
    -m, --initial-mesh=s       initial scene estimate (.obj)
    -n, --iterations=i         refinement iterations        (default 2)
    -o, --output=s             output mesh                  (default output.obj)
    -s, --scale=f              downsample input video       (default 1.0)
    -v / -V                    verbose / hyper-verbose

plus framework extensions: --seed (the reference uses unseeded cv::randu,
heuristic.cpp:365; we default to a fixed seed for reproducibility), --synthetic
(render fixture frames from the scene geometry instead of decoding the clip;
the sample videos are not shipped with the reference's tracks), --poisson-grid,
--checkpoint-dir/--resume, and --mesh-devices for multi-chip sharding.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Optional

import numpy as np

from meshrecon.io.tracks import TrackFile, load_tracks


@dataclasses.dataclass
class Config:
    track: TrackFile
    frames: np.ndarray  # (F, H, W) float32 grayscale 0..255
    iteration_count: int = 2
    verbosity: int = 0
    use_farneback: bool = False
    camera_threshold: float = 10.0
    scene_resolution: float = 1.0  # kept for parity (recon.hpp:73); unused
    scaling_factor: float = 1.0
    skip_frames: int = 1
    out_file_name: str = "output.obj"
    in_mesh_file: Optional[str] = None
    seed: int = 0
    # dense-depth estimator: "flow" (pure reference algorithm),
    # "plane-sweep", or "hybrid" (plane-sweep on iteration 1 where the
    # alpha-shape surface is too crude for flow, then flow refinement —
    # measured 1.7x more accurate single-shot)
    depth_mode: str = "flow"
    sampling: str = "taylor"  # flow-displaced depth sampling: taylor | exact
    # HS linearized-system solver: "cheb" (default — Chebyshev-accelerated
    # Jacobi, same fixed point at ~1/3 the sweeps), "jacobi" (plain
    # relaxation sweeps — one fused fori_loop per level) or "mg" (multigrid
    # W-cycles, flow/multigrid.py: 3x less arithmetic and better converged,
    # but its ~19 coarse-level visits per solve fragment into hundreds of
    # small XLA ops, so it is an option, not the default)
    flow_solver: str = "cheb"
    sweep_depths: int = 64
    # plane-sweep passes per iteration-1 camera: pass 2+ recomputes each
    # side's visibility from the previous pass's swept depth map itself
    # (pipeline.fused.splat_visibility) instead of the crude alpha-shape
    # shadow maps where the signed deep bias concentrates
    sweep_passes: int = 1
    poisson_grid: int = 128
    poisson_sigma: float = 1.5
    # drop this quantile of lowest-confidence points from the Poisson splat
    # (the points stay in the pipeline); 0 disables
    confidence_prune: float = 0.0
    # drop Poisson faces farther than this many grid cells from any input
    # point (screened-Poisson --trim analog; kills the hallucinated closure
    # on partial-coverage scenes); 0 disables. Default 2.0: never worse on
    # any measured seed/scale and large wins at low res and on
    # well-covered draws (BASELINE.md full-res + 1/8-res trim studies)
    poisson_trim: float = 2.0
    # deterministic camera-policy repairs (heuristic._enforce_coverage):
    # fraction of surface shots that must see a chosen main camera (greedy
    # set-cover top-up; 0 disables), and the side-weight ratio above which
    # a better-baseline side is appended to a bundle (0 disables)
    camera_coverage: float = 0.0
    # seed-ensemble reconstruction: refine the cloud under each of these
    # independent camera-draw seeds and mesh the UNION once (per-run quality
    # tracks draw luck — the reference's unseeded cv::randu has the same
    # variance by construction, heuristic.cpp:365); empty = single draw
    ensemble_seeds: tuple = ()
    # a main "covers" a shot only when its cos/d^2 view weight is within
    # this fraction of the best possible main for that shot (0 = mere
    # visibility, which one arc camera satisfies everywhere)
    coverage_quality: float = 0.25
    baseline_diversity: float = 0.0
    # floor on the number of main-camera bundles: when the stochastic
    # accumulate-to-threshold draw stops short (a bad seed can stop at 2-4
    # bundles), promote the highest-accumulated
    # sub-threshold (main, side) pairs from the selection's own weight
    # table until this many mains are chosen; 0 disables
    min_bundles: int = 0
    # iterated-consensus trim of the final cloud before meshing: mesh, drop
    # points > consensus_tau * median-NN-distance from the surface, re-mesh
    # (with re-admission) this many times. Attacks the draw-luck garbage
    # minority that no static per-point signal finds (round-4 attribution:
    # worst-seed med 0.0345 -> 0.0107 r at 1/8 res). 0 disables.
    consensus_rounds: int = 0
    consensus_tau: float = 3.0
    # cap on sides per camera bundle (0 = uncapped). Capping pins the
    # compiled flow-stack K shapes to the {4, 8} bucket set so a new camera
    # draw can never trigger a fresh compile mid-study (the
    # reference's policy is uncapped, heuristic.cpp:372-426 — an extension;
    # truncation drops the LAST-accumulated sides, the weakest by
    # threshold-crossing order)
    max_sides: int = 8
    max_render_faces: int = 65536
    # flow-solver knobs (0 = keep the module default / env override):
    # validated, visible in --help, and appliable per-process via
    # apply_kernel_knobs() — the MESHRECON_FLOW_* env vars still work as
    # the defaults.
    flow_iters: int = 0      # relaxation sweeps/warp (0 = solver default)
    flow_fine_warps: int = 0  # warp iterations at the finest level only
    flow_levels: int = 0     # pyramid depth (0 = pipeline default 2)
    flow_warps: int = 0      # coarse-level warps (0 = pipeline 1/library 2)
    variance_mode: str = ""   # "" = default; rewarp|taylor (fused.py)
    checkpoint_dir: Optional[str] = None
    profile_dir: Optional[str] = None
    resume: bool = False
    mesh_devices: int = 1
    scene_devices: int = 1
    exposure: Optional[np.ndarray] = None
    # lazy clip decode for multi-scene batches: frames may be None with a
    # loader that decodes on first use (ensure_frames) — eagerly decoding
    # every scene's full float32 clip before scene 0 even starts peaks at
    # N x clip size host RAM (8 x 1080p x 400 frames > 24 GB) although the
    # sequential driver needs one clip at a time
    frames_loader: Optional[object] = None
    shape_hint: Optional[tuple] = None  # (F, H, W) when frames is None

    def ensure_frames(self) -> None:
        if self.frames is None:
            loaded = self.frames_loader()
            if isinstance(loaded, tuple):
                loaded, self.exposure = loaded
            self.frames = np.asarray(loaded, np.float32)

    def release_frames(self) -> None:
        if self.frames_loader is not None:
            self.frames = None

    @property
    def width(self) -> int:
        if self.frames is None:
            return int(self.shape_hint[2])
        return int(self.frames.shape[2])

    @property
    def height(self) -> int:
        if self.frames is None:
            return int(self.shape_hint[1])
        return int(self.frames.shape[1])

    @property
    def cameras(self) -> np.ndarray:
        return self.track.cameras

    def camera(self, i: int) -> np.ndarray:
        return self.track.cameras[i]

    def frame(self, i: int) -> np.ndarray:
        self.ensure_frames()  # lazy multi-scene configs decode on first use
        return self.frames[i]

    @property
    def frame_count(self) -> int:
        if self.frames is None:
            return int(self.shape_hint[0])
        return len(self.frames)

    def reconstructed_points(self) -> np.ndarray:
        return self.track.bundles

    def log(self, level: int, msg: str) -> None:
        if self.verbosity >= level:
            print(msg, flush=True)


def _decode_clip(track: TrackFile, skip_frames: int, width: int, height: int):
    """Decode the clip into RAM like configuration.cpp:227-238 (cv2 host IO).

    OpenCV is imported here only: the synthetic-frame path runs without it."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            "decoding a video clip needs OpenCV (the cv2 module), which is "
            "not installed; --synthetic renders frames without it") from e

    clip = cv2.VideoCapture(track.clip_path)
    if not clip.isOpened():
        raise FileNotFoundError(f"Cannot read clip {track.clip_path}")
    frames = []
    fi = 0
    tracked = track.frame_count
    while len(frames) < tracked:
        ok, frame = clip.read()
        if not ok:
            break
        if fi % skip_frames == 0:
            if frame.shape[0] != height or frame.shape[1] != width:
                frame = cv2.resize(frame, (width, height),
                                   interpolation=cv2.INTER_AREA)
            frames.append(frame)
        fi += 1
    clip.release()
    if len(frames) < tracked:
        raise RuntimeError(
            f"clip {track.clip_path} has {len(frames)} usable frames, "
            f"need {tracked}"
        )
    return frames


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="recon",
        description="Reconstructs dense geometry from given YAML scene "
        "calibration and video",
    )
    p.add_argument("input_pos", nargs="*",
                   help="input YAML scene file(s); several files run as a "
                        "multi-scene batch (the reference is one clip per "
                        "process, configuration.cpp:169)")
    p.add_argument("-i", "--input", dest="input")
    p.add_argument("-m", "--initial-mesh", dest="initial_mesh")
    # default=None so multi-scene routing can tell an explicit
    # `-o output.obj` from the unset default (string equality cannot)
    p.add_argument("-o", "--output", default=None)
    p.add_argument("-c", "--camera-threshold", type=float, default=10.0)
    p.add_argument("-e", "--estimate-exposure", action="store_true")
    p.add_argument("-n", "--iterations", type=int, default=2)
    p.add_argument("-s", "--scale", type=float, default=1.0)
    p.add_argument("-k", "--skip-frames", type=int, default=1)
    p.add_argument("-f", "--farneback", action="store_true")
    p.add_argument("-v", "--verbose", action="count", default=0)
    p.add_argument("-V", "--hyper-verbose", action="store_true")
    # framework extensions
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic", choices=["sphere", "plane", "auto"],
                   default=None,
                   help="render fixture frames instead of decoding the clip")
    p.add_argument("--depth-mode",
                   choices=["flow", "plane-sweep", "hybrid"],
                   default="hybrid",
                   help="dense depth estimator: reference-style flow + "
                        "Gauss-Newton, plane-sweep photometric matching, or "
                        "hybrid (plane-sweep bootstrap on iteration 1, flow "
                        "refinement after; the default — most accurate)")
    p.add_argument("--sweep-depths", type=int, default=64,
                   help="number of plane-sweep depth hypotheses")
    p.add_argument("--flow-solver", choices=["cheb", "mg", "jacobi"],
                   default="cheb",
                   help="variational-flow linear solver: Chebyshev-"
                        "accelerated Jacobi (default; same fixed point, "
                        "~3x fewer sweeps), plain fused Jacobi sweeps, or "
                        "multigrid W-cycles (better converged per flop but "
                        "bound by the overhead of many small ops)")
    p.add_argument("--sweep-passes", type=int, default=1,
                   help="plane-sweep passes on iteration 1; pass 2+ "
                        "re-derives side visibility from the previous "
                        "pass's swept depth (fixes alpha-shape shadow-mask "
                        "bias)")
    p.add_argument("--sampling", choices=["taylor", "exact"], default="taylor",
                   help="depth sampling at flow-displaced positions: "
                        "gather-free first-order taylor (default) or exact "
                        "bilinear (reference semantics)")
    p.add_argument("--poisson-grid", type=int, default=128)
    p.add_argument("--poisson-sigma", type=float, default=1.5,
                   help="Gaussian smoothing (grid cells) of the FFT Poisson solve")
    p.add_argument("--confidence-prune", type=float, default=0.0,
                   help="drop this quantile of lowest-confidence points "
                        "from the Poisson splat (0 disables)")
    p.add_argument("--poisson-trim", type=float, default=2.0,
                   help="trim Poisson faces farther than this many grid "
                        "cells from any input point (screened-Poisson "
                        "--trim analog; default 2, 0 disables)")
    p.add_argument("--preset", choices=("quality",), default=None,
                   help="named lever bundle. 'quality' = the measured-best "
                        "full-res preset (BASELINE.md round 4): 3-draw "
                        "seed ensemble + 3 consensus-trim rounds on top of "
                        "the default support trim — med <= 0.10 r and p90 "
                        "<= 0.30 r on EVERY studied seed (worst 0.084 / "
                        "0.180). Explicit flags win over the preset; costs "
                        "~3x device compute (or 3 chips via "
                        "--scene-devices 3)")
    p.add_argument("--ensemble-seeds", default=None, metavar="S1,S2,...",
                   help="reconstruct the point cloud under each of these "
                        "camera-draw seeds and mesh the union (averages out "
                        "draw luck; seeds run sequentially on one chip or "
                        "one-per-device with --scene-devices)")
    p.add_argument("--camera-coverage", type=float, default=0.0,
                   help="enforce that this fraction of surface shots is WELL "
                        "seen by a chosen main camera (deterministic greedy "
                        "top-up of the randomized policy; 0 disables)")
    p.add_argument("--coverage-quality", type=float, default=0.25,
                   help="view-weight fraction of the best-possible main "
                        "below which a shot does not count as covered "
                        "(0 = mere visibility)")
    p.add_argument("--baseline-diversity", type=float, default=0.0,
                   help="append a better-parallax side to a bundle when the "
                        "best outside side outweighs the best in-bundle "
                        "side by this ratio (0 disables)")
    p.add_argument("--min-bundles", type=int, default=0,
                   help="floor on chosen main-camera bundles: promote the "
                        "highest-accumulated sub-threshold pairs from the "
                        "policy's own weight table until this many mains "
                        "are chosen (0 disables)")
    p.add_argument("--consensus-rounds", type=int, default=0,
                   help="iterated-consensus trim rounds on the final cloud "
                        "before meshing: mesh, drop points far from the "
                        "surface, re-mesh with re-admission (0 disables). "
                        "Targets camera-draw garbage minorities; host-side "
                        "cost only")
    p.add_argument("--consensus-tau", type=float, default=3.0,
                   help="consensus keep distance in units of the cloud's "
                        "median nearest-neighbor spacing")
    p.add_argument("--max-sides", type=int, default=8,
                   help="cap on side cameras per bundle (0 = uncapped): "
                        "pins the compiled K-bucket shapes to {4, 8} so "
                        "seed/config changes never re-pay compiles")
    p.add_argument("--max-render-faces", type=int, default=65536,
                   help="decimate the render/policy proxy mesh above "
                        "this face count (output mesh unaffected)")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--mesh-devices", type=int, default=1,
                   help="shard main cameras across this many jax devices")
    p.add_argument("--scene-devices", type=int, default=1,
                   help="with several input YAMLs: run scenes in lockstep "
                        "with the dense stage sharded one-scene-per-device "
                        "across this many jax devices")
    p.add_argument("--profile", default=None, metavar="LOG_DIR",
                   help="write a jax.profiler trace of the run to LOG_DIR")
    p.add_argument("--flow-iters", type=int, default=0,
                   help="relaxation sweeps per flow warp (0 = per-solver "
                        "default: 14 Chebyshev / 60 Jacobi; 20 restores "
                        "the pre-round-4 Chebyshev budget)")
    p.add_argument("--flow-fine-warps", type=int, default=0,
                   help="warp iterations at the FINEST pyramid level only "
                        "(0 = default 1; 2 restores the pre-round-4 "
                        "double warp); the finest warp+solve pair is the "
                        "costliest flow stage")
    p.add_argument("--flow-levels", type=int, default=0,
                   help="flow pyramid depth (0 = pipeline default 2; 3 "
                        "restores the round-4 config, 6 the deep pyramid). "
                        "The pipeline's flows run against rendered "
                        "predictions with few-pixel residuals; shallower "
                        "pyramids skip coarse levels that only matter for "
                        "large displacements (round-5 gate: BASELINE.md)")
    p.add_argument("--flow-warps", type=int, default=0,
                   help="warp iterations at the NON-finest pyramid levels "
                        "(0 = pipeline default 1, library default 2; 2 "
                        "restores each coarse level's re-linearization "
                        "pass — the pipeline's rendered-prediction flows "
                        "are sub-pixel after the upsampled init, round-5 "
                        "gate: BASELINE.md)")
    p.add_argument("--variance-mode", choices=("rewarp", "taylor"),
                   default="",
                   help="flow-variance re-warp: 'rewarp' re-gathers the "
                        "side stack with the final flow (bicubic); 'taylor' "
                        "reuses the solver's final warp + gradients "
                        "(first-order, no second gather pass)")
    return p


def apply_kernel_knobs(config) -> None:
    """Apply a Config's flow/variance knobs to their modules (validated; the
    setters clear jit caches when a value actually changes, so earlier
    traces cannot go stale). A zero knob RESTORES the import-time default —
    back-to-back study configs must not leak overrides into each other."""
    from meshrecon.flow import variational
    from meshrecon.pipeline import fused

    d_it, d_fw, d_lv, d_w = variational._DEFAULTS
    variational.set_flow_knobs(
        iters=getattr(config, "flow_iters", 0) or d_it,
        fine_warps=getattr(config, "flow_fine_warps", 0) or d_fw,
        levels=getattr(config, "flow_levels", 0) or d_lv,
        warps=getattr(config, "flow_warps", 0) or d_w)
    fused.set_variance_mode(
        getattr(config, "variance_mode", "") or fused._DEFAULT_VARIANCE)


def config_from_args(argv=None) -> Config:
    """Single-scene form: exactly one input YAML (the reference CLI)."""
    return configs_from_args(argv)[0]


def configs_from_args(argv=None) -> list:
    """One Config per input YAML. With several inputs, each scene's output
    comes from -o: a ``{}`` placeholder is formatted with the scene index,
    any other explicit -o gets the index inserted before the extension
    (``/r/out.obj`` -> ``/r/out0.obj``), and the untouched default falls
    back to ``<input stem>.obj`` next to each input."""
    args = build_parser().parse_args(argv)
    in_files = ([args.input] if args.input else []) + list(args.input_pos)
    if not in_files:
        print("No configuration YAML file given, exiting.", file=sys.stderr)
        raise SystemExit(1)
    configs = []
    for idx, in_file in enumerate(in_files):
        import os.path

        if len(in_files) == 1:
            out = args.output or "output.obj"
        elif args.output is None:
            out = os.path.splitext(in_file)[0] + ".obj"
        elif "{}" in args.output:
            out = args.output.format(idx)
        else:
            # explicit -o without a placeholder: keep the user's directory
            # and name, disambiguate by scene index (silently writing next
            # to the inputs instead would lose the outputs)
            stem, ext = os.path.splitext(args.output)
            out = f"{stem}{idx}{ext or '.obj'}"
        cfg = _config_for_file(args, in_file, out, lazy=len(in_files) > 1)
        if len(in_files) > 1 and cfg.checkpoint_dir:
            # scenes must not clobber each other's iteration snapshots
            cfg.checkpoint_dir = os.path.join(cfg.checkpoint_dir,
                                              f"scene{idx}")
        configs.append(cfg)
    return configs


def _config_for_file(args, in_file: str, out_file: str,
                     lazy: bool = False) -> Config:
    skip = max(1, args.skip_frames)
    track = load_tracks(in_file, skip_frames=skip)

    scale = args.scale if args.scale and args.scale > 1 else 1.0
    width = int(track.width / scale)
    height = int(track.height / scale)
    if track.width % max(scale, 1) or track.height % max(scale, 1):
        print(
            "Warning: downscale factor does not divide the frame size "
            "(configuration.cpp:149-151 warns here too)",
            file=sys.stderr,
        )

    exposure = None
    gray = None
    loader = None
    shape_hint = None
    if args.synthetic:
        from meshrecon.io.synthetic import synthetic_frames

        gray = synthetic_frames(track, width, height, mode=args.synthetic,
                                seed=args.seed)
    else:
        def decode():
            bgr = _decode_clip(track, skip, width, height)
            if args.estimate_exposure:
                from meshrecon.pipeline.exposure import estimate_exposure

                return estimate_exposure(
                    bgr, track.cameras, track.bundles, track.bundles_enabled,
                    track.distortion, track.center_x / scale,
                    track.center_y / scale, width, height,
                    dump_tab=args.hyper_verbose,
                )
            # BGR -> gray with the Rec.601 weights cv::cvtColor applies
            # (configuration.cpp:243-245)
            return np.stack(
                [
                    (
                        0.114 * f[..., 0].astype(np.float32)
                        + 0.587 * f[..., 1].astype(np.float32)
                        + 0.299 * f[..., 2].astype(np.float32)
                    )
                    for f in bgr
                ]
            )

        if lazy:
            # multi-scene batch: decode on first use so host RAM peaks at
            # one clip, not the whole batch (reconstruct_scenes releases
            # each scene's frames when it finishes)
            loader = decode
            shape_hint = (track.frame_count, height, width)
        else:
            gray = decode()
            if isinstance(gray, tuple):
                gray, exposure = gray

    verbosity = 99 if args.hyper_verbose else (2 if args.verbose else 0)
    if args.preset == "quality":
        # measured-best full-res preset (BASELINE.md round 4): 3-draw
        # ensemble union + iterated-consensus trim — meets the med <= 0.10
        # / p90 <= 0.30 sphere-radius target on every studied seed.
        # Explicit flags win.
        if args.consensus_rounds == 0:
            args.consensus_rounds = 3
        if not args.ensemble_seeds:
            args.ensemble_seeds = (f"{args.seed},{args.seed + 10},"
                                   f"{args.seed + 20}")
    return Config(
        track=track,
        frames=None if gray is None else np.asarray(gray, np.float32),
        frames_loader=loader,
        shape_hint=shape_hint,
        iteration_count=args.iterations,
        verbosity=verbosity,
        use_farneback=args.farneback,
        camera_threshold=args.camera_threshold,
        scaling_factor=scale,
        skip_frames=skip,
        out_file_name=out_file,
        in_mesh_file=args.initial_mesh,
        seed=args.seed,
        depth_mode=args.depth_mode,
        sampling=args.sampling,
        flow_solver=args.flow_solver,
        sweep_depths=args.sweep_depths,
        sweep_passes=args.sweep_passes,
        poisson_grid=args.poisson_grid,
        max_render_faces=args.max_render_faces,
        poisson_sigma=args.poisson_sigma,
        confidence_prune=args.confidence_prune,
        poisson_trim=args.poisson_trim,
        camera_coverage=args.camera_coverage,
        ensemble_seeds=tuple(
            int(s) for s in args.ensemble_seeds.split(",") if s.strip()
        ) if args.ensemble_seeds else (),
        coverage_quality=args.coverage_quality,
        baseline_diversity=args.baseline_diversity,
        min_bundles=args.min_bundles,
        consensus_rounds=args.consensus_rounds,
        consensus_tau=args.consensus_tau,
        max_sides=args.max_sides,
        checkpoint_dir=args.checkpoint_dir,
        profile_dir=args.profile,
        resume=args.resume,
        mesh_devices=args.mesh_devices,
        scene_devices=args.scene_devices,
        exposure=exposure,
        flow_iters=args.flow_iters,
        flow_fine_warps=args.flow_fine_warps,
        flow_levels=args.flow_levels,
        flow_warps=args.flow_warps,
        variance_mode=args.variance_mode,
    )
