"""Real-video ingest: encode a clip, then run the production decode path.

The reference caches the whole clip into RAM with optional frame skipping and
downscaling, then converts BGR->gray (configuration.cpp:227-245). Every other
e2e test uses --synthetic; these tests exercise the actual cv2 decode branch
of config_from_args end to end.
"""

import io as _io
import os

import numpy as np
import pytest

from meshrecon.io.blender_export_tracks import write_tracks_yaml
from meshrecon.pipeline.config import config_from_args

cv2 = pytest.importorskip("cv2")

W, H = 64, 48
PROJ = [[1.5, 0, 0, 0], [0, 2.0, 0, 0], [0, 0, -1.2, -3.4], [0, 0, -1, 0]]


def _write_scene(tmp_path, n_cams, width=W, height=H, clip="clip.avi"):
    buf = _io.StringIO()
    write_tracks_yaml(
        buf,
        {"path": clip, "width": width, "height": height, "fov": 1.1,
         "distortion": (0.0, 0.0, 0.0), "center_x": width / 2,
         "center_y": height / 2},
        [{"frame": i + 1, "near": 2.0, "far": 20.0, "projection": PROJ,
          "position": [0.1 * i, 0, 0, 1]} for i in range(n_cams)],
        [{"bundle": [0, 0, 5, 1], "frames_enabled": list(range(1, n_cams + 1))}],
    )
    path = tmp_path / "scene.yaml"
    path.write_text(buf.getvalue())
    return str(path)


def _write_clip(path, n_frames, width=W, height=H):
    """Solid-colour frames (resize-invariant); BGR value encodes frame index."""
    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 24,
                         (width, height))
    assert wr.isOpened()
    colors = []
    for i in range(n_frames):
        bgr = (40 + 20 * i, 60 + 15 * i, 80 + 10 * i)
        wr.write(np.full((height, width, 3), bgr, np.uint8))
        colors.append(bgr)
    wr.release()
    return colors


def test_multi_scene_lazy_decode(tmp_path):
    """Multi-scene batches decode clips lazily: configs carry a loader
    (host RAM peaks at one clip, not the batch), shapes answer from the
    hint, ensure_frames materializes, release_frames frees."""
    from meshrecon.pipeline.config import configs_from_args

    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir(), b.mkdir()
    ya = _write_scene(a, n_cams=3)
    yb = _write_scene(b, n_cams=3)
    _write_clip(a / "clip.avi", 3)
    colors = _write_clip(b / "clip.avi", 3)

    cfgs = configs_from_args([ya, yb])
    assert all(c.frames is None for c in cfgs), "must not decode eagerly"
    assert (cfgs[0].height, cfgs[0].width) == (H, W)  # from shape_hint
    cfgs[1].ensure_frames()
    assert cfgs[1].frames.shape == (3, H, W)
    want = 0.114 * colors[0][0] + 0.587 * colors[0][1] + 0.299 * colors[0][2]
    assert abs(float(np.median(cfgs[1].frames[0])) - want) < 4.0
    cfgs[1].release_frames()
    assert cfgs[1].frames is None
    # single scene stays eager (no behavior change)
    one = configs_from_args([ya])
    assert one[0].frames is not None


def test_decode_gray_rec601(tmp_path):
    yaml = _write_scene(tmp_path, n_cams=3)
    colors = _write_clip(tmp_path / "clip.avi", 3)
    cfg = config_from_args([yaml])
    assert cfg.frames.shape == (3, H, W)
    for i, (b, g, r) in enumerate(colors):
        want = 0.114 * b + 0.587 * g + 0.299 * r
        got = float(np.median(cfg.frames[i]))
        # MJPG is lossy; solid frames survive within a few levels
        assert abs(got - want) < 4.0, (i, got, want)


def test_decode_skip_frames(tmp_path):
    """-k 2 keeps every 2nd raw frame AND every 2nd camera (cfg.cpp:186-191)."""
    yaml = _write_scene(tmp_path, n_cams=5)
    colors = _write_clip(tmp_path / "clip.avi", 5)
    cfg = config_from_args([yaml, "-k", "2"])
    assert cfg.frame_count == 3  # cameras 1,3,5
    for ci, ri in enumerate([0, 2, 4]):
        b, g, r = colors[ri]
        want = 0.114 * b + 0.587 * g + 0.299 * r
        assert abs(float(np.median(cfg.frames[ci])) - want) < 4.0


def test_decode_downscale(tmp_path):
    """-s 2 halves the decoded resolution (configuration.cpp:160-165)."""
    yaml = _write_scene(tmp_path, n_cams=2)
    _write_clip(tmp_path / "clip.avi", 2)
    cfg = config_from_args([yaml, "-s", "2"])
    assert cfg.width == W // 2 and cfg.height == H // 2
    assert cfg.frames.shape == (2, H // 2, W // 2)


def test_decode_short_clip_fails(tmp_path):
    """Fewer usable frames than tracked cameras is a hard ingest error."""
    yaml = _write_scene(tmp_path, n_cams=6)
    _write_clip(tmp_path / "clip.avi", 3)
    with pytest.raises(RuntimeError, match="usable frames"):
        config_from_args([yaml])


def test_decode_missing_clip_fails(tmp_path):
    yaml = _write_scene(tmp_path, n_cams=2, clip="nope.avi")
    with pytest.raises(FileNotFoundError):
        config_from_args([yaml])


def test_decode_resizes_mismatched_clip(tmp_path):
    """Clip resolution differing from the YAML header is resized on decode."""
    yaml = _write_scene(tmp_path, n_cams=2)  # YAML says 64x48
    _write_clip(tmp_path / "clip.avi", 2, width=128, height=96)
    cfg = config_from_args([yaml])
    assert cfg.frames.shape == (2, H, W)


def test_e2e_through_decoded_clip(tmp_path):
    """A short reconstruct() run whose frames came from a real video file.

    Renders the koule synthetic fixture frames, encodes them to MJPG, decodes
    through the production path, and runs one iteration at low res — the
    full pipeline driven by actual video IO rather than --synthetic.
    """
    from meshrecon.io.synthetic import synthetic_frames
    from meshrecon.io.tracks import load_tracks
    from meshrecon.pipeline.reconstruct import reconstruct

    src = load_tracks("tracks/koule-tr.yaml")
    w, h = 80, 60
    gray = synthetic_frames(src, w, h, mode="sphere", seed=0)

    # encode the synthetic frames as a 3-channel clip at full YAML res
    clip = tmp_path / "koule.avi"
    wr = cv2.VideoWriter(str(clip), cv2.VideoWriter_fourcc(*"MJPG"), 24,
                         (src.width, src.height))
    assert wr.isOpened()
    for f in gray:
        big = cv2.resize(f.astype(np.uint8), (src.width, src.height),
                         interpolation=cv2.INTER_NEAREST)
        wr.write(np.stack([big] * 3, axis=-1))
    wr.release()

    # rewrite the scene YAML next to the clip
    text = open("tracks/koule-tr.yaml").read().replace(
        "koule-perlin.mkv", "koule.avi")
    yaml = tmp_path / "koule.yaml"
    yaml.write_text(text)

    out = tmp_path / "out.obj"
    cfg = config_from_args([str(yaml), "-s", "8", "-n", "1",
                            "-o", str(out), "--seed", "1"])
    assert cfg.frames.shape[0] == src.frame_count
    assert cfg.width == src.width // 8 and cfg.height == src.height // 8
    reconstruct(cfg)
    assert os.path.exists(out)


def test_e2e_multi_scene_lazy_sequential(tmp_path):
    """Two-scene sequential reconstruct_scenes over LAZILY decoded clips:
    each scene decodes on first use and releases its frames afterwards
    (host RAM bounded at one clip, see Config.frames_loader)."""
    from meshrecon.io.synthetic import synthetic_frames
    from meshrecon.io.tracks import load_tracks
    from meshrecon.pipeline.config import configs_from_args
    from meshrecon.pipeline.reconstruct import reconstruct_scenes

    src = load_tracks("tracks/koule-tr.yaml")
    gray = synthetic_frames(src, 80, 60, mode="sphere", seed=0)
    yamls = []
    for s in range(2):
        d = tmp_path / f"s{s}"
        d.mkdir()
        wr = cv2.VideoWriter(str(d / "koule.avi"),
                             cv2.VideoWriter_fourcc(*"MJPG"), 24,
                             (src.width, src.height))
        assert wr.isOpened()
        for f in gray:
            big = cv2.resize(f.astype(np.uint8), (src.width, src.height),
                             interpolation=cv2.INTER_NEAREST)
            wr.write(np.stack([big] * 3, axis=-1))
        wr.release()
        text = open("tracks/koule-tr.yaml").read().replace(
            "koule-perlin.mkv", "koule.avi")
        (d / "koule.yaml").write_text(text)
        yamls.append(str(d / "koule.yaml"))

    cfgs = configs_from_args(yamls + ["-s", "8", "-n", "1", "--seed", "1",
                                      "-o", str(tmp_path / "out.obj")])
    assert all(c.frames is None for c in cfgs)  # lazy until reconstructed
    meshes = reconstruct_scenes(cfgs)
    assert len(meshes) == 2
    assert all(c.frames is None for c in cfgs), "frames must be released"
    # explicit -o without {}: index inserted before the extension
    assert os.path.exists(str(tmp_path / "out0.obj"))
    assert os.path.exists(str(tmp_path / "out1.obj"))


def test_e2e_through_decoded_clip_320x240(tmp_path):
    """Same real-video e2e at -s 2 (320x240): catches resolution-dependent
    decode/pipeline bugs the 80x60 variant can't see.
    One iteration, plane-sweep depth (the hybrid default's first pass) and
    a coarse Poisson grid keep the CPU cost bounded."""
    from meshrecon.io.synthetic import synthetic_frames
    from meshrecon.io.tracks import load_tracks
    from meshrecon.io.obj import read_mesh
    from meshrecon.pipeline.reconstruct import reconstruct

    src = load_tracks("tracks/koule-tr.yaml")
    gray = synthetic_frames(src, 160, 120, mode="sphere", seed=0)

    clip = tmp_path / "koule.avi"
    wr = cv2.VideoWriter(str(clip), cv2.VideoWriter_fourcc(*"MJPG"), 24,
                         (src.width, src.height))
    assert wr.isOpened()
    for f in gray:
        big = cv2.resize(f.astype(np.uint8), (src.width, src.height),
                         interpolation=cv2.INTER_NEAREST)
        wr.write(np.stack([big] * 3, axis=-1))
    wr.release()

    text = open("tracks/koule-tr.yaml").read().replace(
        "koule-perlin.mkv", "koule.avi")
    yaml = tmp_path / "koule.yaml"
    yaml.write_text(text)

    out = tmp_path / "out.obj"
    cfg = config_from_args([str(yaml), "-s", "2", "-n", "1",
                            "-o", str(out), "--seed", "1",
                            "--poisson-grid", "48", "--sweep-depths", "24"])
    assert (cfg.width, cfg.height) == (320, 240)
    reconstruct(cfg)
    mesh = read_mesh(str(out))
    assert len(mesh.faces) > 100
    assert np.isfinite(mesh.vertices).all()


def test_preset_quality_maps_levers(tmp_path):
    """--preset quality = 3-draw ensemble + consensus trim (BASELINE.md
    round-4 measured-best — med/p90 target met on every studied seed);
    explicit flags must win over the preset."""
    yaml = _write_scene(tmp_path, n_cams=2)
    _write_clip(tmp_path / "clip.avi", 2)
    cfg = config_from_args([yaml, "--preset", "quality", "--seed", "7"])
    assert cfg.consensus_rounds == 3
    assert cfg.ensemble_seeds == (7, 17, 27)
    assert cfg.poisson_trim == 2.0  # the default trim rides along

    cfg = config_from_args([yaml, "--preset", "quality", "--seed", "7",
                            "--consensus-rounds", "1",
                            "--ensemble-seeds", "4,5,6"])
    assert cfg.consensus_rounds == 1
    assert cfg.ensemble_seeds == (4, 5, 6)

    cfg = config_from_args([yaml])
    assert cfg.consensus_rounds == 0 and cfg.ensemble_seeds == ()
