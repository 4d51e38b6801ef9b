"""Device time of the fused update's stages on one GPU, at the bench shape.

Two readings at bench.py's shape (B=4 main cameras x K=4 sides, 640x480):

1. Isolated stages. Each stage's program alone, timed with the host clock
   around ``block_until_ready``: the depth renders, the projection gathers,
   one full-stack flow warp, the bicubic variance re-warp, the whole
   64-plane sweep, and the finest level's relaxation sweeps. Beside each
   time: the bytes the stage must move at least (every input read once,
   every output written once; ``_min_bytes_*`` below) and the share of the
   card's memory bandwidth that makes.
2. A profiler trace of a few fused updates in a row: the device's busy and
   idle share over the window, and the kernels that take the most device
   time, each with the stage its HLO metadata names.

Refuses to run without a GPU. Usage:

    python tools/stage_times.py [--trace-dir DIR]
"""

from __future__ import annotations

import argparse
import collections
import glob
import os
import re
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

B, K, H, W = 4, 4, 480, 640
HS_ITERS = 14  # the pipeline's Chebyshev sweeps per warp (variational.py)
SWEEP_DEPTHS = 64  # Config.sweep_depths

# HBM bandwidth by device_kind (NVIDIA H100 SXM data sheet). A device that
# is not here has no roofline share.
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}

# stage of a kernel, from the function names in its HLO op_name metadata;
# the first match wins
STAGES = (
    ("raster", ("render_depth", "binned_depth_raster")),
    ("projection", ("projected_image",)),
    ("mix", ("mix_background",)),
    ("flow", ("variational_flow", "farneback_flow")),
    ("variance", ("compare", "flow_remap")),
    ("triangulate", ("triangulate",)),
    ("normals", ("estimate_normals",)),
)


def _timed(fn, args, reps):
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps, first


def _min_bytes_projection(n_img, px):
    # depth of the B mains, K side frames and side depths in; intensity
    # (f32) and mask (bool) out
    return 4 * B * px + 2 * 4 * n_img * px + 5 * n_img * px


def _min_bytes_warp(n_img, px):
    # image and (fx, fy) in, warped image out
    return 4 * n_img * px * 4


def _min_bytes_sweep(n_img, px):
    # per plane: the side frames and main frames in, the scan's 7-plane
    # per-pixel carry in and out
    return SWEEP_DEPTHS * 4 * px * (n_img + B + 2 * 7 * B)


def _min_bytes_hs(n_img, px):
    # per sweep: u, v, the previous iterate, the linearization point and
    # the two images in, the new u, v out
    return HS_ITERS * 4 * n_img * px * 10


def isolated_stages(card, peak):
    import jax
    import jax.numpy as jnp

    import __graft_entry__ as g
    from meshrecon.depth.plane_sweep import plane_sweep_depth_batched
    from meshrecon.flow.remap import bilinear_warp, flow_remap
    from meshrecon.flow.variational import _hs_sweeps_cheb
    from meshrecon.pipeline.fused import fused_main_update_batched
    from meshrecon.raster.fragment import projected_image_batched
    from meshrecon.raster.rasterizer import raster_engine, render_depths

    prob = jax.device_put(g._fused_problem(b=B, k=K, h=H, w=W, seed=0))
    soup, valid, mains, fm, sides, fs = prob[:6]
    n_img, px = B * K, H * W
    rng = np.random.default_rng(0)
    all_cams = jnp.concatenate([mains[:, None], sides], 1).reshape(-1, 4, 4)
    depths = jax.jit(lambda c, s, v: render_depths(c, s, v, H, W))(
        all_cams, soup, valid).reshape(B, K + 1, H, W)
    flow = jnp.asarray(rng.normal(0, 2, (n_img, H, W, 2)), jnp.float32)
    imgs = fs.reshape(n_img, H, W)
    hs_in = (imgs, imgs + 1.0, flow[..., 0], flow[..., 1])

    stages = [
        ("fused update (whole)", None, jax.jit(
            lambda *a: fused_main_update_batched(*a, height=H, width=W)),
         prob),
        (f"raster ({raster_engine()}, {B * (K + 1)} cameras)", None,
         jax.jit(lambda c, s, v: render_depths(c, s, v, H, W)),
         (all_cams, soup, valid)),
        ("projection gathers", _min_bytes_projection,
         projected_image_batched,
         (mains, depths[:, 0], fs, sides, depths[:, 1:])),
        ("flow warp (bilinear, full stack)", _min_bytes_warp,
         jax.jit(jax.vmap(bilinear_warp)), (imgs, flow)),
        ("variance re-warp (bicubic)", _min_bytes_warp,
         jax.jit(jax.vmap(flow_remap)), (flow, imgs)),
        (f"plane sweep ({SWEEP_DEPTHS} planes)", _min_bytes_sweep,
         jax.jit(lambda *a: plane_sweep_depth_batched(
             *a, num_depths=SWEEP_DEPTHS)),
         (fm, fs, mains, sides, jnp.ones((B, K), bool),
          jnp.full(B, -0.9, jnp.float32), jnp.full(B, 0.9, jnp.float32))),
        (f"HS sweeps ({HS_ITERS}, finest level)", _min_bytes_hs,
         jax.jit(lambda p, n, u, v: _hs_sweeps_cheb(p, n, u, v, 144.0,
                                                    HS_ITERS)), hs_in),
    ]
    print(f"isolated stages at B={B} K={K} {W}x{H} on {card}")
    for name, min_bytes, fn, args in stages:
        per, first = _timed(fn, args, reps=20)
        line = (f"  {name:<36} {per * 1e3:9.3f} ms  (first call "
                f"{first:.1f} s)")
        if min_bytes is not None:
            nbytes = min_bytes(n_img, px)
            line += f"  min bytes {nbytes / 1e6:9.1f} MB"
            if peak:
                line += f"  roofline share {nbytes / peak / per:.3f}"
        print(line, flush=True)
    return prob


def _kernel_key(name):
    """A kernel's name as the HLO instruction's, with '.' and '-' as '_'
    (the GPU backend names a fusion's kernel that way)."""
    return re.sub(r"[.\-]", "_", name)


def _kernel_stage_map(compiled_text):
    """Kernel key -> stage, from each HLO instruction's op_name."""
    out = {}
    pat = re.compile(r"%?([\w.\-]+) = .*?op_name=\"([^\"]*)\"")
    for m in pat.finditer(compiled_text):
        name, op_name = m.group(1), m.group(2)
        for stage, keys in STAGES:
            if any(k in op_name for k in keys):
                out[_kernel_key(name)] = stage
                break
    return out


def _stage(kernel, stage_of):
    """The stage of a kernel event: by its HLO instruction, else by its own
    name (a Pallas kernel is named after itself)."""
    stage = stage_of.get(_kernel_key(kernel))
    if stage is None:
        stage = next((s for s, keys in STAGES
                      if any(k in kernel for k in keys)), "other")
    return stage


def _union_ns(intervals):
    total, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def traced_window(card, prob, trace_dir, steps=5):
    import jax
    from jax.profiler import ProfileData

    from meshrecon.pipeline.fused import fused_main_update_batched

    fn = jax.jit(lambda *a: fused_main_update_batched(*a, height=H, width=W))
    stage_of = _kernel_stage_map(fn.lower(*prob).compile().as_text())
    jax.block_until_ready(fn(*prob))
    with jax.profiler.trace(trace_dir):
        with jax.profiler.TraceAnnotation("stage_times_window"):
            for _ in range(steps):
                out = fn(*prob)
            jax.block_until_ready(out)
    path = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    data = ProfileData.from_file(path)

    window = None
    kernels = []
    for plane in data.planes:
        lines = list(plane.lines)
        if plane.name.startswith("/host"):
            for line in lines:
                for ev in line.events:
                    if ev.name == "stage_times_window":
                        window = (ev.start_ns, ev.start_ns + ev.duration_ns)
            continue
        if not plane.name.startswith("/device"):
            continue
        print(f"  trace plane {plane.name}: " + ", ".join(
            f"{line.name} ({sum(1 for _ in line.events)})" for line in lines))
        for line in lines:
            if line.name.startswith("Stream"):
                kernels += [(ev.name, ev.start_ns, ev.duration_ns)
                            for ev in line.events]
    if not kernels:
        print("  no kernel events on a device plane: busy share not "
              "measured")
        return
    k0 = min(s for _, s, _ in kernels)
    k1 = max(s + d for _, s, d in kernels)
    busy = _union_ns([(s, s + d) for _, s, d in kernels])
    print(f"fused update x{steps} traced on {card}")
    print(f"  kernel span {(k1 - k0) / 1e6:.3f} ms, device busy "
          f"{busy / 1e6:.3f} ms, idle share of the kernel span "
          f"{1 - busy / (k1 - k0):.3f}")
    if window is not None:
        span = window[1] - window[0]
        print(f"  host window {span / 1e6:.3f} ms, idle share of the host "
              f"window {1 - busy / span:.3f} (host and device clocks as "
              f"the trace aligns them)")
    by_name = collections.Counter()
    by_stage = collections.Counter()
    for name, _, dur in kernels:
        by_name[name] += dur
        by_stage[_stage(name, stage_of)] += dur
    total = sum(by_name.values())
    print("  device time by stage (per update):")
    for stage, ns in by_stage.most_common():
        print(f"    {stage:<12} {ns / steps / 1e6:9.3f} ms  "
              f"{ns / total:6.1%}")
    gather = sum(ns for n, ns in by_name.items() if "gather" in n)
    print(f"  kernels named *gather*: {gather / steps / 1e6:.3f} ms per "
          f"update")
    print("  top kernels (per update):")
    for name, ns in by_name.most_common(15):
        stage = _stage(name, stage_of)
        print(f"    {ns / steps / 1e6:9.3f} ms  {stage:<12} {name[:90]}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace-dir", default=None,
                    help="where the profiler trace goes (default: a "
                         "temporary directory)")
    args = ap.parse_args(argv)

    from meshrecon.utils.compile_cache import enable_compile_cache
    from meshrecon.utils.device import card_name_and_power, require_gpu

    dev = require_gpu()
    card = card_name_and_power()
    print(card, flush=True)
    enable_compile_cache()
    peak = PEAK_BYTES_PER_S[dev.device_kind]
    prob = isolated_stages(card, peak)
    traced_window(card, prob, args.trace_dir or tempfile.mkdtemp(
        prefix="stage_times_"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
