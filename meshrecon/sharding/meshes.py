"""Multi-chip execution: device meshes and the sharded dense-update step.

The reference is a single synchronous process (SURVEY.md section 2.2/2.3);
its latent parallelism axes become explicit jax.sharding axes here:

- ``camera``: main cameras within an iteration are independent until the
  point-accumulation merge (recon.cpp:65-119) -> data parallelism.
- ``tile``: pixel rows of each frame -> spatial parallelism for large frames
  (the 1080p/32-frame plane-sweep config). XLA inserts halo exchanges for the
  windowed ops automatically from the sharding annotations.
- the only cross-chip communication is the implicit all-gather when results
  are returned replicated — the analog of the reference's shared `points`
  accumulation (recon.cpp:115-116).

Strategy: annotate in/out shardings on one jitted program (GSPMD) rather than
hand-writing collectives; the program is the same code that runs single-chip.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from meshrecon.depth import triangulate_pixels, estimate_normals
from meshrecon.flow.variational import variational_flow


def make_device_mesh(n_camera: int, n_tile: int = 1, devices=None) -> Mesh:
    """(camera, tile) device mesh over the first n_camera*n_tile devices."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    need = n_camera * n_tile
    if devices.size < need:
        raise ValueError(f"need {need} devices, have {devices.size}")
    grid = devices[:need].reshape(n_camera, n_tile)
    return Mesh(grid, ("camera", "tile"))


def make_scene_mesh(n_scene: int, n_camera: int, n_tile: int = 1,
                    devices=None) -> Mesh:
    """(scene, camera, tile) mesh for multi-clip batches (BASELINE config #5:
    8 clips in parallel, one per device)."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    need = n_scene * n_camera * n_tile
    if devices.size < need:
        raise ValueError(f"need {need} devices, have {devices.size}")
    grid = devices[:need].reshape(n_scene, n_camera, n_tile)
    return Mesh(grid, ("scene", "camera", "tile"))


# flow presets: "full" matches the production pipeline call (levels=2,
# warps=1 explicit, solver-default sweep count — pipeline/fused.py,
# round-5 lv2w1 gate); "fast" is for dry runs and compile checks
_FLOW_PRESETS = {
    "full": dict(levels=2, warps=1),
    "fast": dict(levels=2, iters=20, warps=1),
}


def dense_update_batch(frames_main, frames_proj, main_cams, side_cams,
                       side_valid, depths, centers, centers_valid, n_side,
                       flow_quality: str = "full"):
    """Batched dense update: flow -> triangulation -> normals for B main cams.

    frames_main: (B, H, W) original frames; frames_proj: (B, K, H, W)
    reprojected predictions; main_cams: (B, 4, 4); side_cams: (B, K, 4, 4);
    side_valid: (B, K); depths: (B, H, W); centers: (B, C, 3);
    centers_valid: (B, C); n_side: (B,).

    Returns (point4 (B, H, W, 4), normals (B, H, W, 3), pdf, valid).
    This is the jittable flagship step — vmapped over the camera batch and
    shardable over (camera, tile).
    """
    preset = _FLOW_PRESETS[flow_quality]

    def one(fm, fps, mc, scs, sv, d, ctr, cv, k):
        def flow_of(fp):
            f = variational_flow(fm, fp, **preset)
            from meshrecon.flow.pyramid import compare
            from meshrecon.flow.remap import flow_remap

            var = compare(fm, flow_remap(f, fp))
            return jnp.concatenate(
                [f, var[..., None], jnp.zeros_like(var)[..., None]], axis=-1
            )

        flows = jax.vmap(flow_of)(fps)
        out = triangulate_pixels(flows, mc, scs, sv, d)
        normals = estimate_normals(out["point4"], out["valid"], out["pdf"],
                                   ctr, cv, k)
        return out["point4"], normals, out["pdf"], out["valid"]

    return jax.vmap(one)(frames_main, frames_proj, main_cams, side_cams,
                         side_valid, depths, centers, centers_valid, n_side)


def sharded_dense_update(mesh: Mesh, flow_quality: str = "fast"):
    """Compile dense_update_batch with (camera, tile) shardings on `mesh`.

    Inputs are sharded: batch dim over ``camera``, image rows over ``tile``;
    camera matrices replicated. Outputs are returned replicated, which makes
    XLA insert the closing all-gather (the reference's global point merge,
    recon.cpp:115-116).
    """

    def sh(*spec):
        return NamedSharding(mesh, P(*spec))

    in_shardings = (
        sh("camera", "tile", None),        # frames_main (B, H, W)
        sh("camera", None, "tile", None),  # frames_proj (B, K, H, W)
        sh("camera", None, None),          # main_cams
        sh("camera", None, None, None),    # side_cams
        sh("camera", None),                # side_valid
        sh("camera", "tile", None),        # depths
        sh("camera", None, None),          # centers
        sh("camera", None),                # centers_valid
        sh("camera"),                      # n_side
    )
    out_shardings = (
        sh(),  # point4 replicated -> all-gather
        sh(),  # normals replicated
        sh(),  # pdf
        sh(),  # valid
    )
    def step(*args):
        return dense_update_batch(*args, flow_quality=flow_quality)

    return jax.jit(step, in_shardings=in_shardings,
                   out_shardings=out_shardings)


def sharded_fused_update(mesh: Mesh, height: int, width: int,
                         use_farneback: bool = False):
    """The COMPLETE per-iteration device step, sharded over (camera, tile):
    z-buffer depth renders, shadowed reprojection, dense flow, triangulation
    and normals (pipeline.fused.fused_main_update) for a batch of B main
    cameras. The triangle soup is replicated (the mesh is global state, like
    the reference's single VBO, render_glx.cpp:230-258); frames and all dense
    intermediates are sharded; outputs come back replicated (the closing
    all-gather). The binned raster kernel is a custom call that the
    partitioner does not split, so each device renders the whole batch's
    depth maps; everything after the renders is sharded."""
    from meshrecon.pipeline.fused import fused_main_update

    def step(soup, soup_valid, main_cams, frames_main, side_cams, side_frames,
             side_valid, centers, centers_valid, n_side):
        return jax.vmap(
            lambda mc, fm, scs, sfs, sv, ctr, cv, k: fused_main_update(
                soup, soup_valid, mc, fm, scs, sfs, sv, ctr, cv, k,
                height=height, width=width, use_farneback=use_farneback,
            )
        )(main_cams, frames_main, side_cams, side_frames, side_valid,
          centers, centers_valid, n_side)

    def sh(*spec):
        return NamedSharding(mesh, P(*spec))

    in_shardings = (
        sh(),                              # soup (replicated)
        sh(),                              # soup_valid
        sh("camera", None, None),          # main_cams
        sh("camera", "tile", None),        # frames_main
        sh("camera", None, None, None),    # side_cams
        sh("camera", None, "tile", None),  # side_frames
        sh("camera", None),                # side_valid
        sh("camera", None, None),          # centers
        sh("camera", None),                # centers_valid
        sh("camera"),                      # n_side
    )
    out_shardings = {
        "point4": sh(), "normals": sh(), "pdf": sh(), "valid": sh(),
        "depth": sh(),
    }
    return jax.jit(step, in_shardings=in_shardings,
                   out_shardings=out_shardings)


# (the legacy unfused multi-scene pair multi_scene_update /
# sharded_multi_scene_update was deleted in round 3: superseded by
# sharded_multi_scene_fused, which shards the COMPLETE per-camera update
# including each scene's own soup and is what the production driver
# pipeline.reconstruct._reconstruct_scenes_sharded dispatches)


def sharded_plane_sweep(mesh: Mesh, num_depths: int = 64):
    """Window-sharded plane sweep: the K side frames of one main camera are
    split across the mesh's ``window`` axis; each device scores its frames
    against the same depth plane and the photometric evidence (cost
    numerator + view support) reduces with one ``psum`` per plane.
    This is the framework's long-context axis (BASELINE config #4: a
    32-frame window at 1080p): memory per chip stays O(K/n * H * W), the
    depth scan rides sequentially, and the evidence reduction is the
    pass-the-block pattern of ring attention.

    Returns a jitted step
    ``(frame_main, frames_side, cam_main, cams_side, side_valid, z_min,
    z_max) -> {depth, cost, valid}`` where frames_side/cams_side/side_valid
    are sharded on their leading window axis; outputs are replicated.
    """
    from functools import partial

    from meshrecon.sharding.compat import shard_map

    from meshrecon.depth.plane_sweep import plane_sweep_depth

    axis = "window"
    assert axis in mesh.axis_names, f"mesh needs a '{axis}' axis"

    fn = shard_map(
        partial(plane_sweep_depth, num_depths=num_depths, axis_name=axis),
        mesh=mesh,
        in_specs=(P(), P(axis), P(), P(axis), P(axis), P(), P()),
        out_specs={"depth": P(), "cost": P(), "valid": P()},
        check_rep=False,
    )
    return jax.jit(fn)


def make_window_mesh(n_window: int, devices=None) -> Mesh:
    """1-D device mesh over the plane-sweep frame window."""
    devices = devices if devices is not None else jax.devices()[:n_window]
    return Mesh(np.asarray(devices).reshape(n_window), ("window",))


def sharded_multi_scene_fused(mesh: Mesh, height: int, width: int,
                              use_farneback: bool = False,
                              sampling: str = "taylor",
                              flow_solver: str = "cheb"):
    """Scene-sharded FUSED dense update: each device runs the complete
    batched per-camera update (pipeline.fused.fused_main_update_batched —
    renders, reprojection, flow, triangulation, normals) for its local
    scene(s), including each scene's OWN triangle soup. Replaces the legacy
    ``sharded_multi_scene_update`` path (which shards the unfused
    dense_update_batch and needs precomputed depths/reprojections).

    Uses shard_map: inside a shard the program is the plain single-scene
    code, so the raster kernel runs untransformed on each device's own
    soup.
    Scenes are fully independent — no collective at all; outputs stay
    scene-sharded.

    Every per-scene array gains a leading S axis (soup included:
    (S, T, 3, 3)). S must be divisible by the mesh's scene-axis size.
    """
    from functools import partial

    from meshrecon.sharding.compat import shard_map

    from meshrecon.pipeline.fused import fused_main_update_batched

    assert "scene" in mesh.axis_names

    def local(soup, soup_valid, mains, fms, scs, sfs, svs, ctrs, cvs, ks):
        def per_scene(args):
            so, sv_, mc, fm, sc, sf, svv, ct, cv, k = args
            return fused_main_update_batched(
                so, sv_, mc, fm, sc, sf, svv, ct, cv, k,
                height=height, width=width, use_farneback=use_farneback,
                sampling=sampling, flow_solver=flow_solver)

        return jax.lax.map(per_scene, (soup, soup_valid, mains, fms, scs,
                                       sfs, svs, ctrs, cvs, ks))

    spec = P("scene")
    fn = shard_map(
        local, mesh=mesh,
        in_specs=(spec,) * 10,
        out_specs={"point4": spec, "normals": spec, "pdf": spec,
                   "valid": spec, "depth": spec},
        check_rep=False,
    )
    return jax.jit(fn)
