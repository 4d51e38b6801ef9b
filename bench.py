"""Benchmark: time of the fused per-main-camera dense update on one GPU.

Times the COMPLETE fused update — depth renders, shadow-mapped reprojection
of K side frames, pyramidal variational flow, covariance-weighted
Gauss-Newton triangulation and PCA normals — for B main cameras at 640x480
on a sphere soup, with the host clock around work that ends in
``block_until_ready``. Compile time is reported as set-up. Refuses to run
without a GPU.

Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import json
import os
import sys
import time


def main():
    import jax

    from meshrecon.utils.compile_cache import enable_compile_cache
    from meshrecon.utils.device import card_name_and_power, require_gpu

    dev = require_gpu()
    card = card_name_and_power()
    print(card, flush=True)
    enable_compile_cache()

    import __graft_entry__ as g
    from meshrecon.pipeline.fused import fused_main_update_batched

    B, K, H, W = 4, 4, 480, 640
    args = jax.device_put(g._fused_problem(b=B, k=K, h=H, w=W, seed=0))

    def step(*a):
        return fused_main_update_batched(*a, height=H, width=W)

    fn = jax.jit(step)
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    compile_s = time.perf_counter() - t0

    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / reps

    print(json.dumps({
        "metric": "fused_update_ms",
        "value": dt * 1e3,
        "unit": "ms per B-camera dispatch",
        "mpix_per_s": B * H * W / dt / 1e6,
        "camera_batch": B,
        "sides": K,
        "compile_s": compile_s,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
