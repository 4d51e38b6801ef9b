"""BASELINE.json configs #4 and #5 — record the numbers.

Config #4 — long-context stress: 32-frame sliding-window plane sweep at
1080p. Runs on the attached GPU (in-program reps, ended by block_until_ready)
and reports Mpix/s of dense depth; the window-SHARDED variant
(sharding.sharded_plane_sweep) is validated on the virtual 8-device CPU
mesh by tests/test_sharding.py and exercised here single-real-chip.

Config #5 — multi-scene batch: 8 scenes' fused dense updates in one
sharded dispatch over a (scene,) mesh. With one device the run is still
the REAL sharded program; scenes need no cross-scene collective (the only
communication is input distribution; see sharding/meshes.py).

Usage: python tools/baseline_configs.py [c4|c5]
"""

from __future__ import annotations

import sys
import time

import numpy as np


def config4():
    import jax
    import jax.numpy as jnp

    from meshrecon.depth.plane_sweep import plane_sweep_depth

    H, W, K, D = 1080, 1920, 32, 64
    reps = 3
    print(f"# config4: {H}x{W}, {K}-frame window, {D} depths, "
          f"{jax.devices()}", flush=True)

    rng = np.random.default_rng(0)
    # synthetic textured window: smooth base + per-frame shift
    base = rng.uniform(0, 255, size=(H // 8, W // 8)).astype(np.float32)
    fm = np.kron(base, np.ones((8, 8), np.float32))
    fs = np.stack([np.roll(fm, (i % 7, (3 * i) % 11), axis=(0, 1))
                   for i in range(K)])

    def cam(i):
        import __graft_entry__ as g
        return g._make_camera(eye=(0.15 * i, 0.05 * (i % 3), 0),
                              aspect=H / W)

    main = cam(0)
    cams = np.stack([cam(i + 1) for i in range(K)]).astype(np.float32)
    sv = np.ones(K, bool)

    def many(eps, fm_, fs_):
        def body(i, acc):
            out = plane_sweep_depth(fm_ + acc * 1e-30, fs_, main, cams, sv,
                                    -0.8, 0.6, num_depths=D)
            return acc * 1e-30 + jnp.sum(out["depth"]) + jnp.sum(out["cost"])
        return jax.lax.fori_loop(0, reps, body, jnp.float32(eps))

    fjit = jax.jit(many)
    args = (jnp.float32(0.0), jax.device_put(fm), jax.device_put(fs))
    t0 = time.perf_counter()
    jax.block_until_ready(fjit(*args))
    tc = time.perf_counter() - t0
    best = 1e9
    for _ in range(2):
        t0 = time.perf_counter()
        jax.block_until_ready(fjit(*args))
        best = min(best, time.perf_counter() - t0)
    per = best / reps
    mpix = H * W / per / 1e6
    print(f"config4: {per*1e3:.1f} ms per 32-frame/64-depth window solve "
          f"at 1080p  = {mpix:.1f} Mpix/s dense depth "
          f"(compile {tc:.0f}s)", flush=True)


def config5():
    import jax
    import jax.numpy as jnp

    import __graft_entry__ as g
    from meshrecon.sharding import make_scene_mesh, sharded_multi_scene_fused

    S, B, K, H, W = 8, 2, 2, 240, 320
    n_dev = min(S, len(jax.devices()))
    print(f"# config5: {S} scenes x {B} cams, {H}x{W}, K={K}, "
          f"{n_dev} device(s), fused", flush=True)
    mesh = make_scene_mesh(n_dev, 1, 1, devices=jax.devices()[:n_dev])
    step = sharded_multi_scene_fused(mesh, height=H, width=W)

    args1 = g._fused_problem(b=B, k=K, h=H, w=W, seed=0)
    argsS = tuple(np.stack([a] * S) for a in args1)

    t0 = time.perf_counter()
    out = step(*argsS)
    jax.block_until_ready(out)
    tc = time.perf_counter() - t0
    best = 1e9
    for _ in range(2):
        t0 = time.perf_counter()
        out = step(*argsS)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    mpix = S * B * H * W / best / 1e6
    print(f"config5: {best*1e3:.1f} ms per {S}-scene x {B}-camera sharded "
          f"FUSED dense update = {mpix:.1f} Mpix/s aggregate "
          f"(compile {tc:.0f}s)", flush=True)


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "c4"
    (config4 if which == "c4" else config5)()
