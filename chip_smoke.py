"""Chip smoke check: drive the video -> mesh pipeline once on an NVIDIA GPU.

Run from the repository root on a machine with a GPU:

    python chip_smoke.py              # one card: all phases below
    python chip_smoke.py --four-gpus  # four cards: the multi-device paths

One process opens the card once and runs, each phase printing its lines:

1. device    the card's name and power limit, device kind, jax version,
             XLA_FLAGS, compile-cache directory, native meshing library;
2. kernels   the binned Triton raster compiled at 640x480 for the B*(1+K)
             cameras of a dispatch, its memory analysis, its agreement with
             the XLA renderer (render_depth) and both times, at 512 to
             65,536 triangles;
3. precision the fused update (640x480, B=4, K=4, 16k-triangle sphere) on
             the GPU against the same update on the CPU;
4. e2e       the full-resolution CLI run on koule-tr (-n 2) with its stage
             report, and a --scale 8 run scored against the true sphere.

With --four-gpus it runs only the paths that exist across cards, each
against its one-card counterpart: --mesh-devices 4 against the one-card
batched step on the same bundles, and a 4-seed ensemble sharded over
--scene-devices 4 against the same seeds run one after another.

Every failed check raises, so the script exits non-zero; the last line of
a passing run is the JSON device record. Without a GPU it exits non-zero
before any phase.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

_ROOT = os.path.dirname(os.path.abspath(__file__))
_TRACK = os.path.join(_ROOT, "tracks", "koule-tr.yaml")
H, W = 480, 640
B, K = 4, 4  # the pipeline's camera batch and side bucket
RASTER_TRIS = (512, 4096, 16384, 65536)


class Phase:
    """Prints a phase's header and its wall time; lets exceptions through."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        print(f"== phase {self.name}", flush=True)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            print(f"== phase {self.name} ok "
                  f"({time.perf_counter() - self.t0:.1f} s)", flush=True)
        return False


def check(cond, what):
    if not cond:
        raise AssertionError(what)
    print(f"  ok: {what}", flush=True)


def _timed(fn, *args, reps):
    import jax

    jax.block_until_ready(fn(*args))  # compile + warm
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps, out


def koule_scene():
    """(track, sphere center, radius): the scene's fitted sphere, which the
    synthetic frames render."""
    from meshrecon.io.synthetic import fit_sphere
    from meshrecon.io.tracks import load_tracks

    track = load_tracks(_TRACK)
    center, radius = fit_sphere(track.bundles)
    return track, np.asarray(center, np.float32), float(radius)


def sphere_soup(n_tris, center, radius):
    """Morton-sorted sphere soup of n_tris triangles, padded to the
    pipeline's capacity class."""
    import __graft_entry__ as g
    from meshrecon.raster.rasterizer import _soup_capacity, morton_order

    n_theta = int(np.sqrt(n_tris / 4))
    soup = g._sphere_soup(n_theta=n_theta, n_phi=n_tris // (2 * n_theta),
                          center=tuple(center), radius=radius)
    soup = soup[morton_order(soup)]
    cap = _soup_capacity(len(soup))
    pad = np.zeros((cap, 3, 3), np.float32)
    pad[:len(soup)] = soup
    valid = np.zeros(cap, bool)
    valid[:len(soup)] = True
    return pad, valid, len(soup)


def bundle_cameras(track):
    """B main cameras with K sides each, spread over the clip."""
    f = track.frame_count
    mains = [int(i * (f - 1) / (B + 1)) + 2 for i in range(B)]
    sides = [[min(max(m + d, 0), f - 1) for d in (-2, -1, 1, 2)]
             for m in mains]
    return mains, sides


def phase_device(card):
    import jax

    from meshrecon.meshing import native
    from meshrecon.utils.compile_cache import enable_compile_cache

    print(f"  card (name, power limit): {card}")
    dev = jax.devices()[0]
    print(f"  device_kind: {dev.device_kind}; platform {dev.platform}; "
          f"count {len(jax.devices())}")
    print(f"  jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    print(f"  compile cache: {enable_compile_cache()}")
    lib = native._build_and_load()
    print(f"  native meshing library: {'loaded' if lib else 'NOT loaded'}")
    check(lib is not None, "native meshing library built and loaded")


def phase_kernels(card, track, center, radius):
    import jax
    import jax.numpy as jnp

    from meshrecon.raster.binned import render_depth_binned
    from meshrecon.raster.rasterizer import render_depth

    mains, sides = bundle_cameras(track)
    cams = np.stack([track.cameras[i] for m, s in zip(mains, sides)
                     for i in [m] + s]).astype(np.float32)
    n = len(cams)
    triton = jax.jit(lambda c, s, v: render_depth_binned(c, s, v, H, W))
    xla_one = jax.jit(lambda c, s, v: render_depth(c, s, v, H, W))

    def xla(c, s, v):
        # one dispatch per camera: XLA compiles the single-camera scan in
        # seconds, a vmapped 20-camera one did not finish in minutes
        return jnp.stack([xla_one(c[i], s, v) for i in range(c.shape[0])])

    tol_frac = 1e-3
    print(f"  tolerance: share of pixels with |triton - xla| > 1e-4 "
          f"<= {tol_frac} (FMA contraction may round an edge test the "
          f"other way, and render_depth has no per-triangle box test)")
    for n_tris in RASTER_TRIS:
        soup, valid, t = sphere_soup(n_tris, center, radius)
        args = (jnp.asarray(cams), jnp.asarray(soup), jnp.asarray(valid))
        compiled = triton.lower(*args).compile()
        mem = compiled.memory_analysis()
        print(f"  [{t} tris, capacity {len(soup)}, {n} cameras {W}x{H}] "
              f"memory_analysis: {mem}")
        reps = 20 if n_tris <= 4096 else 5
        t_tri, d_tri = _timed(triton, *args, reps=reps)
        t_xla, d_xla = _timed(xla, *args, reps=max(1, reps // 5))
        d_tri, d_xla = np.asarray(d_tri), np.asarray(d_xla)
        diff = np.abs(d_tri - d_xla)
        frac = float(np.mean(diff > 1e-4))
        print(f"  [{t} tris] triton {t_tri * 1e3:.3f} ms, xla "
              f"{t_xla * 1e3:.3f} ms per {n}-camera dispatch "
              f"({t_xla / t_tri:.1f}x) on {card}; covered "
              f"{float(np.mean(d_xla < 1.0)):.3f}; mismatch share {frac:.2e}"
              f", max |diff| {float(diff.max()):.3e}")
        check(frac <= tol_frac,
              f"{t} tris: triton raster matches render_depth")


def phase_precision(card, track, center, radius):
    import jax
    import jax.numpy as jnp

    from meshrecon.geometry.camera import np_extract_camera_center
    from meshrecon.io.synthetic import synthetic_frames
    from meshrecon.pipeline.fused import fused_main_update_batched

    frames = synthetic_frames(track, W, H, mode="sphere", seed=0)
    soup, valid, t = sphere_soup(16384, center, radius)
    mains, sides = bundle_cameras(track)
    cam = track.cameras
    centers = np.zeros((B, 8, 3), np.float32)
    cvalid = np.zeros((B, 8), bool)
    for b, (m, s) in enumerate(zip(mains, sides)):
        for j, i in enumerate([m] + s):
            c = np_extract_camera_center(cam[i])
            centers[b, j] = c[:3] / c[3]
            cvalid[b, j] = True
    args = (soup, valid, cam[mains].astype(np.float32), frames[mains],
            np.stack([cam[s] for s in sides]).astype(np.float32),
            np.stack([frames[s] for s in sides]), np.ones((B, K), bool),
            centers, cvalid, np.full(B, K, np.int32))

    def run(raster):
        return jax.jit(lambda *a: fused_main_update_batched(
            *a, height=H, width=W, raster=raster))

    t0 = time.perf_counter()
    gpu = jax.tree_util.tree_map(np.asarray, run(None)(*args))
    print(f"  GPU fused update (first call, compile included): "
          f"{time.perf_counter() - t0:.1f} s")
    cpu_dev = jax.devices("cpu")[0]
    t0 = time.perf_counter()
    with jax.default_device(cpu_dev):
        cpu = jax.tree_util.tree_map(
            np.asarray, run("xla")(*jax.device_put(args, cpu_dev)))
    print(f"  CPU fused update: {time.perf_counter() - t0:.1f} s")

    agree = float(np.mean(gpu["valid"] == cpu["valid"]))
    both = gpu["valid"] & cpu["valid"]
    p_g = gpu["point4"][..., :3] / gpu["point4"][..., 3:4]
    p_c = cpu["point4"][..., :3] / cpu["point4"][..., 3:4]
    perr = np.linalg.norm(p_g - p_c, axis=-1)[both] / radius
    # pixels without enough valid neighbours carry a zero normal on both
    # sides; compare the unit normals only
    unit = (both & (np.linalg.norm(gpu["normals"], axis=-1) > 0.5)
            & (np.linalg.norm(cpu["normals"], axis=-1) > 0.5))
    cosang = np.clip(np.abs(np.sum(gpu["normals"] * cpu["normals"], -1)),
                     0, 1)[unit]
    nerr = np.degrees(np.arccos(cosang))
    print(f"  {t}-triangle sphere, {B}x{K} cameras {W}x{H}: valid pixels "
          f"GPU {int(gpu['valid'].sum())} CPU {int(cpu['valid'].sum())}")
    print(f"  point4 |dp|/r: median {np.median(perr):.3e}, p99 "
          f"{np.percentile(perr, 99):.3e}, max {perr.max():.3e}")
    print(f"  normals angle (deg) over {int(unit.sum())} unit normals: "
          f"median {np.median(nerr):.3e}, p99 "
          f"{np.percentile(nerr, 99):.3e}, max {nerr.max():.3e}")
    print(f"  valid agreement: {agree:.5f}")

    # the raster engine inside the whole fused update, end to end
    for n_tris in (16384, 65536):
        s2, v2, t2 = sphere_soup(n_tris, center, radius)
        a2 = (s2, v2) + args[2:]
        times = {}
        for raster in ("triton", "xla"):
            fn = run(raster)
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*a2))
            first = time.perf_counter() - t0
            times[raster], _ = _timed(fn, *a2, reps=5 if raster == "triton"
                                      else 1)
            print(f"  fused update {B}x{K} {W}x{H} {t2} tris, raster "
                  f"{raster}: {times[raster] * 1e3:.1f} ms per dispatch "
                  f"(first call {first:.1f} s) on {card}")
        check(times["triton"] < times["xla"],
              f"{t2} tris: fused update faster with the triton raster")
    # the two sides differ in raster engine and summation order only; a
    # TF32 contraction would move points by ~1e-3 r everywhere
    check(agree >= 0.995, "valid agreement >= 0.995")
    check(np.median(perr) <= 1e-4, "point4 median |dp|/r <= 1e-4")
    check(np.percentile(perr, 99) <= 1e-2, "point4 p99 |dp|/r <= 1e-2")
    check(np.median(nerr) <= 0.1, "normals median angle <= 0.1 deg")


def _compile_seconds():
    """Accumulate jax's compile-time events (trace, lowering, backend)."""
    import jax

    totals = {}

    def listener(event, duration, **_):
        if event.startswith("/jax/core/compile/"):
            totals[event] = totals.get(event, 0.0) + duration

    jax.monitoring.register_event_duration_secs_listener(listener)
    return totals


def run_cli(argv):
    """meshrecon.cli.main in this process; returns (wall s, mesh)."""
    from meshrecon import cli
    from meshrecon.io.obj import read_mesh

    out = argv[argv.index("-o") + 1]
    t0 = time.perf_counter()
    rc = cli.main(argv)
    wall = time.perf_counter() - t0
    check(rc == 0, f"cli {' '.join(argv[1:])} exited 0")
    mesh = read_mesh(out)
    return wall, mesh


def score(mesh, track):
    sys.path.insert(0, os.path.join(_ROOT, "tools"))
    from quality_harness import SCENE_BOUNDS, scene_truth, surface_error

    mode, params = scene_truth(track)
    med, p90 = surface_error(mesh, mode, params)
    return mode, med, p90, SCENE_BOUNDS["koule-tr"]


def phase_e2e(card, track, tmp):
    from meshrecon.raster import rasterizer

    caps = set()
    load_mesh = rasterizer.Renderer.load_mesh

    def recording_load_mesh(self, mesh):
        load_mesh(self, mesh)
        caps.add(int(self.soup.shape[0]))

    rasterizer.Renderer.load_mesh = recording_load_mesh
    compile_s = _compile_seconds()
    try:
        out = os.path.join(tmp, "koule_full.obj")
        wall, mesh = run_cli([_TRACK, "--synthetic", "sphere", "-s", "1",
                              "-n", "2", "-v", "-o", out])
    finally:
        rasterizer.Renderer.load_mesh = load_mesh
    print(f"  full resolution {W}x{H}, -n 2: wall {wall:.1f} s on {card}")
    for event, secs in sorted(compile_s.items()):
        print(f"  compile {event}: {secs:.1f} s")
    print(f"  soup capacities compiled: {len(caps)} {sorted(caps)}")
    print(f"  output faces: {len(mesh.faces)}")
    check(len(mesh.faces) > 0, "full-resolution OBJ is non-empty")
    mode, med, p90, _ = score(mesh, track)
    print(f"  full resolution vs true {mode}: med {med:.4f} r, p90 "
          f"{p90:.4f} r")

    out8 = os.path.join(tmp, "koule_s8.obj")
    wall8, mesh8 = run_cli([_TRACK, "--synthetic", "sphere", "-s", "8",
                            "-o", out8])
    mode, med, p90, bound = score(mesh8, track)
    print(f"  --scale 8: wall {wall8:.1f} s, {len(mesh8.faces)} faces, "
          f"vs true {mode}: med {med:.4f} r, p90 {p90:.4f} r")
    check(med <= bound, f"--scale 8 median {med:.4f} <= SCENE_BOUNDS "
                        f"koule-tr {bound}")


def four_device_checks(tmp, scale=1, n_dev=4):
    """--mesh-devices and --scene-devices paths against their one-device
    counterparts. Runs on any backend with n_dev devices (the CPU
    rehearsal uses virtual devices)."""
    import jax

    from meshrecon.pipeline.config import config_from_args
    from meshrecon.pipeline.reconstruct import _process_bundles_batched
    from meshrecon.raster import Renderer
    from meshrecon.utils.profiling import StageTimer

    check(len(jax.devices()) >= n_dev, f"{n_dev} devices present")
    track, center, radius = koule_scene()
    base = [_TRACK, "--synthetic", "sphere", "-s", str(scale)]

    # (a) camera-sharded fused step vs the one-device batched step
    cfg = config_from_args(base)
    soup, valid, t = sphere_soup(16384, center, radius)
    renderer = Renderer(cfg.width, cfg.height)
    renderer._soup, renderer._valid = soup, valid
    mains, sides = bundle_cameras(track)
    bundles = [(m, s) for m, s in zip(mains, sides)] * 2  # 8 bundles
    timer = StageTimer(enabled=False)
    t0 = time.perf_counter()
    one = _process_bundles_batched(cfg, renderer, list(bundles), timer)
    t_one = time.perf_counter() - t0
    cfg.mesh_devices = n_dev
    t0 = time.perf_counter()
    many = _process_bundles_batched(cfg, renderer, list(bundles), timer)
    t_many = time.perf_counter() - t0
    print(f"  {len(bundles)} bundles at {cfg.width}x{cfg.height}, {t} tris: "
          f"one device {t_one:.1f} s, --mesh-devices {n_dev} {t_many:.1f} s "
          f"(first calls, compile included)")
    for i, ((p1, _, n1), (p4, _, n4)) in enumerate(zip(one, many)):
        print(f"  bundle {i}: points one-device {n1}, sharded {n4}")
        check(abs(n1 - n4) <= max(2, 0.002 * n1),
              f"bundle {i} point counts agree within 0.2%")
    p1 = np.concatenate([p for p, _, _ in one])
    p4 = np.concatenate([p for p, _, _ in many])
    if len(p1) == len(p4):
        d = np.linalg.norm(p1[:, :3] / p1[:, 3:] - p4[:, :3] / p4[:, 3:],
                           axis=1) / radius
        print(f"  point |dp|/r: median {np.median(d):.3e}, max {d.max():.3e}")
        check(np.median(d) <= 1e-4, "sharded points match (median 1e-4 r)")

    # (b) the scene-sharded fused step (one scene per device, each with its
    # own soup) vs the one-device batched step on each scene's inputs
    from meshrecon.pipeline.reconstruct import _vmapped_step
    from meshrecon.sharding import make_scene_mesh, sharded_multi_scene_fused

    h, w = cfg.height, cfg.width
    scenes = []
    for i, (m, sd) in enumerate(zip(mains, sides)):
        # a different mesh size per scene: 16k, 8k, 4k, 2k triangles
        so, sv, _ = sphere_soup(16384 >> i, center, radius)
        cap = 16384
        so = np.pad(so, ((0, cap - len(so)), (0, 0), (0, 0)))
        sv = np.pad(sv, (0, cap - len(sv)))
        fr = np.stack([cfg.frame(j) for j in [m] + sd])
        cams = np.stack([cfg.camera(j) for j in [m] + sd])
        scenes.append((so, sv, cams[:1], fr[:1], cams[None, 1:], fr[None, 1:],
                       np.ones((1, K), bool), np.zeros((1, 8, 3), np.float32),
                       np.ones((1, 8), bool), np.full(1, K, np.int32)))
    stacked = tuple(np.stack([sc[j] for sc in scenes]) for j in range(10))
    mesh = make_scene_mesh(n_dev, 1, 1, devices=jax.devices()[:n_dev])
    t0 = time.perf_counter()
    sharded = jax.tree_util.tree_map(np.asarray, sharded_multi_scene_fused(
        mesh, height=h, width=w)(*stacked))
    t_sh = time.perf_counter() - t0
    step = _vmapped_step(h, w, False, "taylor", "cheb")
    t0 = time.perf_counter()
    single = [jax.tree_util.tree_map(np.asarray, step(*sc)) for sc in scenes]
    t_one = time.perf_counter() - t0
    print(f"  {n_dev} scenes at {w}x{h}: --scene-devices {n_dev} step "
          f"{t_sh:.1f} s, one device {t_one:.1f} s (first calls, compile "
          f"included)")
    for i, one_out in enumerate(single):
        v1, v4 = one_out["valid"][0], sharded["valid"][i, 0]
        both = v1 & v4
        p1 = one_out["point4"][0][both]
        p4 = sharded["point4"][i, 0][both]
        d = np.linalg.norm(p1[:, :3] / p1[:, 3:] - p4[:, :3] / p4[:, 3:],
                           axis=1) / radius
        print(f"  scene {i}: valid one-device {int(v1.sum())}, sharded "
              f"{int(v4.sum())}; point |dp|/r median {np.median(d):.3e}")
        check(np.mean(v1 == v4) >= 0.999 and np.median(d) <= 1e-4,
              f"scene {i}: sharded step matches the one-device step")

    # (c) the CLI's seed ensemble sharded over the devices, and the same
    # seeds one after another on one device. Iteration 1 takes different
    # plane-sweep drivers in the two (per-scene unbatched when sharded,
    # batched otherwise), so the clouds differ; both must meet the bound.
    seeds = "3,13,14,15"
    for name, extra in (("sequential", []),
                        ("sharded", ["--scene-devices", str(n_dev)])):
        out = os.path.join(tmp, f"ens_{name}.obj")
        wall, mesh = run_cli(base + ["--ensemble-seeds", seeds, "-o", out]
                             + extra)
        mode, med, p90, bound = score(mesh, track)
        print(f"  ensemble {seeds} {name}: wall {wall:.1f} s, "
              f"{len(mesh.faces)} faces, vs true {mode}: med {med:.4f} r, "
              f"p90 {p90:.4f} r")
        check(med <= bound, f"{name} ensemble median {med:.4f} <= {bound}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the four-card paths and their "
                         "one-card counterparts")
    args = ap.parse_args(argv)

    import jax

    from meshrecon.utils.device import card_name_and_power, require_gpu

    dev = require_gpu()
    card = card_name_and_power()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    if args.four_gpus:
        with Phase("device"):
            phase_device(card)
        with Phase("four-gpus"):
            four_device_checks(tmp)
    else:
        track, center, radius = koule_scene()
        with Phase("device"):
            phase_device(card)
        with Phase("kernels"):
            phase_kernels(card, track, center, radius)
        with Phase("precision"):
            phase_precision(card, track, center, radius)
        with Phase("e2e"):
            phase_e2e(card, track, tmp)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
