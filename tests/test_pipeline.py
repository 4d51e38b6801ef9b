import os

import numpy as np
import pytest

from meshrecon.io.tracks import load_tracks
from meshrecon.io.synthetic import synthetic_frames, fit_sphere
from meshrecon.io.obj import read_mesh
from meshrecon.pipeline.config import Config, config_from_args
from meshrecon.pipeline.heuristic import Heuristic, face_camera, face_areas
from meshrecon.pipeline.reconstruct import reconstruct
from meshrecon.raster import Renderer
from meshrecon.io.obj import Mesh


@pytest.fixture(scope="module")
def koule_small():
    """koule-tr scene at 80x60 with synthetic sphere frames."""
    track = load_tracks("tracks/koule-tr.yaml")
    frames = synthetic_frames(track, 80, 60, mode="sphere", seed=0)
    return track, frames


def test_synthetic_frames_consistent(koule_small):
    track, frames = koule_small
    assert frames.shape == (31, 60, 80)
    # the sphere must be visible (textured region differs from background)
    assert frames.std() > 10.0


def test_face_camera_looks_at_face():
    verts = np.array(
        [[0, 0, 0, 1], [1, 0, 0, 1], [0, 1, 0, 1]], dtype=np.float32
    )
    cam = face_camera(verts, np.array([0, 1, 2]), 0.3, 0.3)
    # the face centroid should project near the camera axis with w > 0 shortly
    # along the normal (+z for this face)
    probe = cam.astype(np.float64) @ np.array([0.3, 0.3, 0.5, 1.0])
    assert probe[3] > 0
    ndc = probe[:3] / probe[3]
    assert abs(ndc[0]) < 0.5 and abs(ndc[1]) < 0.5


def test_heuristic_chooses_cameras(koule_small):
    track, frames = koule_small
    cfg = Config(track=track, frames=frames, seed=1)
    hint = Heuristic(cfg)
    assert hint.not_happy(track.bundles)
    mesh = hint.tessellate(track.bundles, np.zeros((len(track.bundles), 3)))
    assert len(mesh.faces) > 0
    r = Renderer(cfg.width, cfg.height)
    r.load_mesh(mesh)
    count = hint.choose_cameras(mesh, track.cameras, r)
    assert count > 0
    bundles = hint.camera_bundles()
    assert len(bundles) > 0
    mains = [m for m, _ in bundles]
    assert mains == sorted(mains)
    for m, sides in bundles:
        assert len(sides) > 0 and m not in sides
        assert all(0 <= s < track.frame_count for s in sides)


def test_heuristic_reproducible(koule_small):
    track, frames = koule_small
    results = []
    for _ in range(2):
        cfg = Config(track=track, frames=frames, seed=7)
        hint = Heuristic(cfg)
        hint.not_happy(track.bundles)
        mesh = hint.tessellate(track.bundles, np.zeros((len(track.bundles), 3)))
        r = Renderer(cfg.width, cfg.height)
        r.load_mesh(mesh)
        hint.choose_cameras(mesh, track.cameras, r)
        results.append(hint.camera_bundles())
    assert results[0] == results[1]


def test_end_to_end_sphere(koule_small, tmp_path):
    """Full pipeline on the synthetic sphere scene: the output mesh must
    approximate the ground-truth sphere used to render the frames."""
    track, frames = koule_small
    out = str(tmp_path / "out.obj")
    cfg = Config(
        track=track,
        frames=frames,
        iteration_count=1,
        out_file_name=out,
        seed=3,
        poisson_grid=64,
        depth_mode="hybrid",  # the CLI default (plane-sweep bootstrap)
        poisson_trim=0.0,  # keep the UNTRIMMED path regression-covered
        # (trim defaults to 2.0 since the full-res study; the trimmed
        # path has its own tighter test below)
        checkpoint_dir=str(tmp_path / "ckpt"),
        verbosity=0,
    )
    mesh = reconstruct(cfg)
    assert os.path.exists(out)
    assert len(mesh.faces) > 50
    center, radius = fit_sphere(track.bundles)
    v3 = mesh.vertices[:, :3] / mesh.vertices[:, 3:4]
    radii = np.linalg.norm(v3 - center, axis=1)
    med = np.median(radii)
    # regression bound: measured 0.103 at this config (80x60, n=1, seed 3)
    # after single-side bundles began contributing sweep points (they are
    # noisier but whole scenes previously came out EMPTY without them);
    # the round-1 guard was 0.25
    assert abs(med - radius) / radius < 0.13, (
        f"median radius {med} vs true {radius}"
    )
    med_abs = np.median(np.abs(radii - radius))
    assert med_abs / radius < 0.14, f"median abs surface error {med_abs}"
    # checkpoint written and resumable
    from meshrecon.pipeline.checkpoint import load_checkpoint

    state = load_checkpoint(str(tmp_path / "ckpt"))
    assert state is not None
    pts, nrm, alphas, it, _ = state
    assert len(pts) == len(nrm) and it == 1 and len(alphas) >= 1


def test_end_to_end_sphere_trimmed(koule_small, tmp_path):
    """--poisson-trim regression: trimming the unsupported Poisson closure
    must hold a much tighter error bound than the untrimmed e2e test
    (measured med 0.022 / p90 0.097 at this config; untrimmed bound 0.13).
    Guards the flagship quality lever."""
    track, frames = koule_small
    cfg = Config(
        track=track,
        frames=frames,
        iteration_count=1,
        out_file_name=str(tmp_path / "trim.obj"),
        seed=3,
        poisson_grid=64,
        depth_mode="hybrid",
        poisson_trim=2.0,
        verbosity=0,
    )
    mesh = reconstruct(cfg)
    assert len(mesh.faces) > 50
    center, radius = fit_sphere(track.bundles)
    v3 = mesh.vertices[:, :3] / mesh.vertices[:, 3:4]
    err = np.abs(np.linalg.norm(v3 - center, axis=1) - radius) / radius
    assert np.median(err) < 0.05, f"median rel err {np.median(err)}"
    assert np.percentile(err, 90) < 0.20, (
        f"p90 rel err {np.percentile(err, 90)}"
    )


def test_cli_smoke(tmp_path, monkeypatch):
    out = str(tmp_path / "cli.obj")
    from meshrecon.cli import main

    rc = main([
        "tracks/koule-tr.yaml", "--synthetic", "sphere", "-s", "8",
        "-n", "1", "-o", out, "--seed", "3", "--poisson-grid", "48",
    ])
    assert rc == 0
    mesh = read_mesh(out)
    assert len(mesh.faces) > 0


def test_stage_timer():
    import jax.numpy as jnp

    from meshrecon.utils.profiling import StageTimer

    t = StageTimer(enabled=True)
    with t.stage("a", pixels=1000) as done:
        done(jnp.ones(10) * 2)
    rep = t.report()
    assert "a" in rep and t.counts["a"] == 1 and t.times["a"] > 0


def test_nan_checks_utils():
    import jax.numpy as jnp

    from meshrecon.utils.debug import checked

    err, out = checked(lambda x: jnp.sqrt(x))(jnp.asarray(4.0))
    assert float(out) == 2.0


def test_end_to_end_plane_sweep(koule_small, tmp_path):
    """Full pipeline with the plane-sweep depth mode (BASELINE config #4
    estimator) on the synthetic sphere scene."""
    track, frames = koule_small
    out = str(tmp_path / "sweep.obj")
    cfg = Config(
        track=track,
        frames=frames,
        iteration_count=1,
        out_file_name=out,
        seed=3,
        poisson_grid=48,
        depth_mode="plane-sweep",
        sweep_depths=32,
    )
    mesh = reconstruct(cfg)
    assert len(mesh.faces) > 50
    center, radius = fit_sphere(track.bundles)
    v3 = mesh.vertices[:, :3] / mesh.vertices[:, 3:4]
    radii = np.linalg.norm(v3 - center, axis=1)
    assert abs(np.median(radii) - radius) / radius < 0.3


def test_resume_from_checkpoint(koule_small, tmp_path):
    """A 2-iteration run checkpointed after iter 1 resumes and completes."""
    track, frames = koule_small
    ckpt = str(tmp_path / "ck")
    out1 = str(tmp_path / "a.obj")
    cfg = Config(track=track, frames=frames, iteration_count=1,
                 out_file_name=out1, seed=5, poisson_grid=48,
                 checkpoint_dir=ckpt)
    reconstruct(cfg)
    # resume with a higher iteration budget: continues at iteration 2
    out2 = str(tmp_path / "b.obj")
    cfg2 = Config(track=track, frames=frames, iteration_count=2,
                  out_file_name=out2, seed=5, poisson_grid=48,
                  checkpoint_dir=ckpt, resume=True)
    mesh = reconstruct(cfg2)
    assert len(mesh.faces) > 0
    from meshrecon.pipeline.checkpoint import load_checkpoint

    pts, nrm, alphas, it, _ = load_checkpoint(ckpt)
    assert it == 2 and len(alphas) >= 2


def test_hyper_verbose_artifacts(koule_small, tmp_path, monkeypatch):
    """-V must dump the reference's intermediate artifacts (recon.cpp:39-134,
    SURVEY.md section 4.3)."""
    track, frames = koule_small
    monkeypatch.chdir(tmp_path)
    cfg = Config(track=track, frames=frames, iteration_count=1,
                 out_file_name="out.obj", seed=3, poisson_grid=48,
                 verbosity=99)
    reconstruct(cfg)
    names = {p.name for p in tmp_path.iterdir()}
    assert "recon_orig.obj" in names
    assert "purepoints.obj" in names and "filteredpoints.obj" in names
    assert any(n.startswith("frame") and n.endswith(".png") for n in names)
    assert any(n.startswith("depth-frame") for n in names)
    assert any(n.startswith("project-frame") for n in names)
    assert any(n.startswith("flow-frame") for n in names)
    assert any("remap-error" in n for n in names)
    assert "out.obj" in names


def test_fused_matches_unfused(koule_small):
    """The single-program fused main-camera update must agree with the
    stage-by-stage path used for -V dumps."""
    import jax
    import jax.numpy as jnp

    from meshrecon.pipeline.fused import fused_main_update
    from meshrecon.pipeline.reconstruct import process_main_camera, _bucket
    from meshrecon.geometry.camera import np_extract_camera_center

    track, frames = koule_small
    cfg = Config(track=track, frames=frames, seed=2, verbosity=0)
    hint = Heuristic(cfg)
    hint.not_happy(track.bundles)
    mesh = hint.tessellate(track.bundles, np.zeros((len(track.bundles), 3)))
    r = Renderer(cfg.width, cfg.height)
    r.load_mesh(mesh)

    fa, sides = 0, [5, 12]
    # fused path with exact sampling (the pipeline default is taylor; exact
    # is what the stage-by-stage path computes)
    from meshrecon.pipeline.fused import fused_main_update
    import jax as _jax
    kb = _bucket(len(sides))
    sc_ = np.tile(np.eye(4, dtype=np.float32), (kb, 1, 1))
    sf_ = np.zeros((kb, cfg.height, cfg.width), np.float32)
    sv_ = np.zeros(kb, bool)
    for i, fb in enumerate(sides):
        sc_[i] = cfg.camera(fb)
        sf_[i] = cfg.frame(fb)
        sv_[i] = True
    ctrs = [np_extract_camera_center(cfg.camera(fa))] + [
        np_extract_camera_center(cfg.camera(fb)) for fb in sides]
    c3 = np.stack([c[:3] / c[3] for c in ctrs]).astype(np.float32)
    cb = _bucket(len(c3))
    cp = np.zeros((cb, 3), np.float32); cp[: len(c3)] = c3
    cv_ = np.zeros(cb, bool); cv_[: len(c3)] = True
    # variance="rewarp" for the same reason as sampling="exact": the
    # stage-by-stage path below uses the literal-parity calculate_flow
    # (true bicubic re-warp, flow.cpp:34); the fused default is the
    # first-order taylor re-warp (PARITY.md divergence 14)
    outf = fused_main_update(
        r.soup, r.soup_valid, cfg.camera(fa),
        jnp.asarray(cfg.frame(fa), jnp.float32), sc_, sf_, sv_, cp, cv_,
        jnp.asarray(len(sides)), height=cfg.height, width=cfg.width,
        sampling="exact", variance="rewarp")
    validf = np.asarray(outf["valid"])
    pts_f = np.asarray(outf["point4"])[validf]
    n_f = int(validf.sum())

    # unfused: force the verbose branch without dumping (verbosity 3 writes
    # files; emulate by calling the stages manually like the old path)
    cam_main = cfg.camera(fa)
    original = jnp.asarray(cfg.frame(fa), jnp.float32)
    depth = r.depth(cam_main)
    from meshrecon.flow import calculate_flow
    from meshrecon.raster import mix_background
    from meshrecon.depth import triangulate_pixels, estimate_normals

    depth0 = depth
    flows, side_cams = [], []
    for fb in sides:
        # projection sees pristine geometry; only the mix chains the depth
        inten, mask = r.projected(cam_main, cfg.frame(fb), cfg.camera(fb),
                                  depth_main=depth0)
        mixed, depth = mix_background(inten, mask, original, depth)
        flows.append(np.asarray(calculate_flow(original, mixed, False)))
        side_cams.append(cfg.camera(fb))
    kb = _bucket(len(flows))
    h, w = cfg.height, cfg.width
    fl = np.zeros((kb, h, w, 4), np.float32)
    fl[: len(flows)] = np.stack(flows)
    sc = np.tile(np.eye(4, dtype=np.float32), (kb, 1, 1))
    sc[: len(side_cams)] = np.stack(side_cams)
    sv = np.zeros(kb, bool)
    sv[: len(side_cams)] = True
    out = triangulate_pixels(fl, cam_main, sc, sv, depth)
    valid_u = np.asarray(out["valid"])
    pts_u = np.asarray(out["point4"])[valid_u]

    assert n_f == valid_u.sum()
    np.testing.assert_allclose(pts_f, pts_u.astype(np.float32), rtol=1e-4,
                               atol=1e-4)


def test_exposure_estimation(koule_small, tmp_path, monkeypatch):
    """Exposure solve normalizes per-frame gains on synthetic BGR frames with
    known exposure variation (configuration.cpp:270-426 semantics)."""
    monkeypatch.chdir(tmp_path)
    track, gray = koule_small
    rng = np.random.default_rng(0)
    gains = 1.0 + 0.3 * np.sin(np.arange(track.frame_count))
    bgr = [
        np.clip(
            np.stack([g * gray[i]] * 3, axis=-1) + rng.normal(scale=1.0,
            size=gray[i].shape + (3,)), 1, 254
        ).astype(np.uint8)
        for i, g in enumerate(gains)
    ]
    from meshrecon.pipeline.exposure import estimate_exposure

    out_gray, exposure = estimate_exposure(
        bgr, track.cameras, track.bundles, track.bundles_enabled,
        track.distortion, track.center_x / 8, track.center_y / 8,
        gray.shape[2], gray.shape[1], dump_tab=True,
    )
    assert out_gray.shape == gray.shape
    # estimated per-frame total gains should counteract the injected gains:
    # exposure_i * gains_i ~ constant
    total = exposure.sum(axis=0) * gains
    spread = total.std() / total.mean()
    assert spread < 0.15, f"gain compensation spread {spread}"
    assert (tmp_path / "exposure.tab").exists()
    lines = (tmp_path / "exposure.tab").read_text().strip().splitlines()
    assert len(lines) == track.frame_count


def test_mesh_devices_pipeline(koule_small, tmp_path):
    """--mesh-devices path: the sharded multi-camera pipeline produces a mesh
    comparable to the single-device run (same seed)."""
    import jax

    if len(jax.devices()) < 2:
        import pytest

        pytest.skip("needs 2+ devices")
    track, frames = koule_small
    out1 = str(tmp_path / "s1.obj")
    out2 = str(tmp_path / "s2.obj")
    base = dict(track=track, frames=frames, iteration_count=1, seed=9,
                poisson_grid=48)
    m1 = reconstruct(Config(out_file_name=out1, mesh_devices=1, **base))
    m2 = reconstruct(Config(out_file_name=out2, mesh_devices=2, **base))
    # same camera draws (same seed) -> same point sets up to f32 sharding
    # nondeterminism; meshes should closely agree in size and geometry
    assert abs(len(m1.faces) - len(m2.faces)) <= max(40, 0.1 * len(m1.faces))
    v1 = m1.vertices[:, :3] / m1.vertices[:, 3:4]
    v2 = m2.vertices[:, :3] / m2.vertices[:, 3:4]
    c1, c2 = v1.mean(axis=0), v2.mean(axis=0)
    assert np.linalg.norm(c1 - c2) < 0.2


def test_zero_cameras_graceful_after_first_iteration(koule_small, tmp_path,
                                                     monkeypatch):
    """When the heuristic finds no pairs in a later iteration, the pipeline
    finishes with the accumulated points instead of dying (divergence from
    recon.cpp:47-50, which exits unconditionally)."""
    track, frames = koule_small
    out = str(tmp_path / "g.obj")
    cfg = Config(track=track, frames=frames, iteration_count=3,
                 out_file_name=out, seed=3, poisson_grid=48)

    calls = {"n": 0}
    orig = Heuristic.choose_cameras

    def flaky(self, mesh, cameras, renderer):
        calls["n"] += 1
        if calls["n"] >= 2:
            self.chosen = []
            return 0
        return orig(self, mesh, cameras, renderer)

    monkeypatch.setattr(Heuristic, "choose_cameras", flaky)
    mesh = reconstruct(cfg)
    assert len(mesh.faces) > 0
    assert os.path.exists(out)


def test_geometric_far_enables_distant_cameras():
    """Scenes whose cameras sit farther than the reference's hardcoded
    far=10 viewer frustum must still produce camera pairs (koberec-scale)."""
    from meshrecon.io.tracks import load_tracks
    from meshrecon.io.synthetic import synthetic_frames

    track = load_tracks("tracks/koberec.yaml")
    frames = synthetic_frames(track, 80, 60, mode="auto", seed=4)
    # the accumulate-to-threshold selection scales with pixel count
    # (heuristic.cpp:441: "units: pixels per scene-space area"); at this tiny
    # test resolution the reference-default threshold of 10 is unreachable,
    # so use the -c knob exactly as the reference intends
    cfg = Config(track=track, frames=frames, seed=4, camera_threshold=0.5)
    hint = Heuristic(cfg)
    hint.not_happy(track.bundles)
    mesh = hint.tessellate(track.bundles, np.zeros((len(track.bundles), 3)))
    r = Renderer(cfg.width, cfg.height)
    r.load_mesh(mesh)
    count = hint.choose_cameras(mesh, track.cameras, r)
    assert count >= 1
    assert len(hint.camera_bundles()) >= 1


def test_initial_mesh_flag(koule_small, tmp_path):
    """-m/--initial-mesh: iteration 1 uses the given OBJ instead of the
    alpha shape (configuration.cpp:62-64, heuristic.cpp:528-534)."""
    from meshrecon.io.obj import save_mesh, Mesh as M
    from meshrecon.meshing import alpha_shape_faces

    track, frames = koule_small
    faces, _ = alpha_shape_faces(track.bundles)
    path = str(tmp_path / "init.obj")
    save_mesh(M(track.bundles, faces), path)
    cfg = Config(track=track, frames=frames, in_mesh_file=path, seed=1)
    hint = Heuristic(cfg)
    hint.not_happy(track.bundles)
    mesh = hint.tessellate(track.bundles, np.zeros((len(track.bundles), 3)))
    assert len(mesh.faces) == len(faces)
    assert hint.alpha_vals[-1] == 1.0  # heuristic.cpp:531


def test_reconstruct_scenes(koule_small, tmp_path):
    """Multi-scene convenience driver: both scenes reconstruct, programs
    are shared (second scene must not recompile: same shapes)."""
    from meshrecon.pipeline.reconstruct import reconstruct_scenes

    track, frames = koule_small
    cfgs = [
        Config(track=track, frames=frames, iteration_count=1, seed=s,
               poisson_grid=64, depth_mode="hybrid",
               out_file_name=str(tmp_path / f"scene{s}.obj"))
        for s in (3, 4)
    ]
    meshes = reconstruct_scenes(cfgs)
    assert len(meshes) == 2
    for s, m in zip((3, 4), meshes):
        assert len(m.faces) > 50
        assert os.path.exists(str(tmp_path / f"scene{s}.obj"))


def test_enforce_coverage_repairs_policy():
    """_enforce_coverage: greedy set-cover top-up + baseline-diversity
    append (the deterministic repairs behind --camera-coverage /
    --baseline-diversity)."""
    import types

    h = Heuristic.__new__(Heuristic)
    h.config = types.SimpleNamespace(camera_coverage=1.0,
                                     baseline_diversity=0.0)
    shots, cams = 4, 4
    ok = np.zeros((shots, cams), bool)
    ok[0, [0, 1]] = True
    ok[1, [1, 2]] = True
    ok[2, [0, 2]] = True
    ok[3, [0, 1, 2]] = True
    cos_v = np.full((shots, cams), 0.8)
    dist = np.ones((shots, cams))
    # distinct screen positions so parallax weights are nonzero
    cfv_n = np.zeros((shots, cams, 3))
    cfv_n[..., 0] = np.linspace(-0.5, 0.5, cams)[None, :]
    cfv_n[..., 1] = np.linspace(0.3, -0.3, shots)[:, None]

    chosen = h._enforce_coverage([], ok, cos_v, dist, cfv_n)
    assert chosen, "coverage enforcement must add bundles"
    covered = np.zeros(shots, bool)
    for m, sides in chosen:
        assert sides and m not in sides
        covered |= ok[:, m]
    assert covered.all(), "every servable shot must see a chosen main"

    # baseline diversity: a main whose only side is itself-adjacent (near
    # zero parallax) gets the wide-baseline side appended
    h.config = types.SimpleNamespace(camera_coverage=0.0,
                                     baseline_diversity=2.0)
    cfv_n2 = np.zeros((shots, cams, 3))
    cfv_n2[..., 0] = np.array([0.0, 0.01, 0.6, 0.6])[None, :]
    ok2 = np.ones((shots, cams), bool)
    chosen2 = h._enforce_coverage([(0, [1])], ok2, cos_v, dist, cfv_n2)
    (main, sides), = chosen2
    assert main == 0 and 1 in sides and len(sides) == 2


def test_enforce_min_bundles_promotes_subthreshold_pairs():
    """_enforce_min_bundles: the bundle-count floor promotes the policy's
    own highest-accumulated sub-threshold pairs, one per new main, and
    never duplicates an already-chosen main."""
    import types

    h = Heuristic.__new__(Heuristic)
    h.config = types.SimpleNamespace(min_bundles=3, verbosity=0)
    weights = {
        (0, 0): 1.0, (0, 1): 1.2,   # chosen pair (over threshold)
        (2, 3): 0.7, (2, 4): 0.4,   # best sub-threshold for main 2
        (5, 1): 0.9,                # best overall sub-threshold
        (0, 4): 0.95,               # main 0 already chosen: skipped
    }
    chosen = h._enforce_min_bundles([(0, [1])], dict(weights))
    assert sorted(m for m, _ in chosen) == [0, 2, 5]
    got = dict(chosen)
    assert got[5] == [1] and got[2] == [3]  # highest-weight side per main

    # floor already met: no-op
    h.config = types.SimpleNamespace(min_bundles=1, verbosity=0)
    assert h._enforce_min_bundles([(0, [1])], dict(weights)) == [(0, [1])]

    # no candidates: floor unmet but no crash
    h.config = types.SimpleNamespace(min_bundles=4, verbosity=0)
    assert h._enforce_min_bundles([(0, [1])], {(0, 0): 1.0}) == [(0, [1])]


def test_min_bundles_end_to_end(koule_small):
    track, frames = koule_small
    base = Config(track=track, frames=frames, seed=1)
    floored = Config(track=track, frames=frames, seed=1, min_bundles=12)
    counts = []
    for cfg in (base, floored):
        hint = Heuristic(cfg)
        hint.not_happy(track.bundles)
        mesh = hint.tessellate(track.bundles,
                               np.zeros((len(track.bundles), 3)))
        r = Renderer(cfg.width, cfg.height)
        r.load_mesh(mesh)
        hint.choose_cameras(mesh, track.cameras, r)
        bundles = hint.camera_bundles()
        for m, sides in bundles:
            assert sides and m not in sides
        counts.append(len(bundles))
    assert counts[1] >= counts[0]
    assert counts[1] >= min(12, counts[0] + 1) or counts[0] >= 12


def test_heuristic_coverage_flags_end_to_end(koule_small):
    track, frames = koule_small
    cfg = Config(track=track, frames=frames, seed=1, camera_coverage=0.95,
                 baseline_diversity=3.0)
    hint = Heuristic(cfg)
    hint.not_happy(track.bundles)
    mesh = hint.tessellate(track.bundles, np.zeros((len(track.bundles), 3)))
    r = Renderer(cfg.width, cfg.height)
    r.load_mesh(mesh)
    count = hint.choose_cameras(mesh, track.cameras, r)
    assert count > 0
    for m, sides in hint.camera_bundles():
        assert sides and m not in sides


def test_end_to_end_consensus_rounds(koule_small, tmp_path):
    """--consensus-rounds regression: the iterated-consensus trim of the
    final cloud (mesh -> drop far points -> re-mesh with re-admission) must
    not degrade a good draw and must produce a valid mesh at least as tight
    as the trimmed bound (the lever's value shows on BAD draws: 1/8-res
    seed-5 med 0.0345 -> 0.0107, tools/remesh_lab.py)."""
    track, frames = koule_small
    cfg = Config(
        track=track,
        frames=frames,
        iteration_count=2,
        out_file_name=str(tmp_path / "cons.obj"),
        seed=3,
        poisson_grid=64,
        depth_mode="hybrid",
        poisson_trim=2.0,
        consensus_rounds=3,
        verbosity=0,
    )
    mesh = reconstruct(cfg)
    assert len(mesh.faces) > 50
    center, radius = fit_sphere(track.bundles)
    v3 = mesh.vertices[:, :3] / mesh.vertices[:, 3:4]
    err = np.abs(np.linalg.norm(v3 - center, axis=1) - radius) / radius
    assert np.median(err) < 0.05, f"median rel err {np.median(err)}"
    assert np.percentile(err, 90) < 0.20, (
        f"p90 rel err {np.percentile(err, 90)}"
    )


def test_multi_scene_final_tessellate_is_final(koule_small, tmp_path,
                                               monkeypatch):
    """Round-4 judge bug: the non-ensemble multi-scene driver's finish()
    dropped final=True, silently skipping --consensus-rounds (a third of
    --preset quality) on that path. Regression: every scene's LAST
    tessellate call must carry final=True."""
    from meshrecon.pipeline.reconstruct import reconstruct_scenes

    calls = []  # (heuristic, final) — strong refs so ids can't be recycled
    orig = Heuristic.tessellate

    def recording(self, points, normals, final=False):
        calls.append((self, final))
        return orig(self, points, normals, final=final)

    monkeypatch.setattr(Heuristic, "tessellate", recording)

    track, frames = koule_small
    cfgs = [
        Config(track=track, frames=frames, iteration_count=1, seed=s,
               poisson_grid=64, depth_mode="hybrid", consensus_rounds=1,
               out_file_name=str(tmp_path / f"fscene{s}.obj"))
        for s in (3, 4)
    ]
    meshes = reconstruct_scenes(cfgs)
    assert len(meshes) == 2
    final_flags = {}  # per-heuristic final kwarg of the LAST call
    for h, fin in calls:
        final_flags[id(h)] = fin
    assert len(final_flags) == 2, "expected one Heuristic per scene"
    assert all(final_flags.values()), (
        "finish() must tessellate with final=True so consensus trim fires"
    )
    del calls  # release the strong refs
