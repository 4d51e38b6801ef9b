import numpy as np
import pytest

from meshrecon.io import load_tracks, read_mesh, save_mesh, Mesh


def test_load_koberec_minus():
    tf = load_tracks("tracks/koberec-.yaml")
    assert tf.width == 640 and tf.height == 480
    assert tf.frame_count == 55
    assert tf.bundles.shape == (30, 4)
    assert tf.cameras.shape == (55, 4, 4)
    assert np.all(tf.camera_valid)
    assert np.all(tf.near > 0) and np.all(tf.far > tf.near)
    assert tf.clip_path.endswith("koberec.avi")
    assert abs(float(tf.distortion[0]) - (-0.19075001776218414)) < 1e-6
    # frames-enabled became 0-based sets
    assert all(isinstance(s, set) for s in tf.bundles_enabled)
    assert all((min(s) >= 0) for s in tf.bundles_enabled if s)


@pytest.mark.parametrize(
    "name,ncams,ntracks",
    [("koberec.yaml", 173, 18), ("zatisi.yaml", 120, 23), ("koule-tr.yaml", 31, 21)],
)
def test_load_all_scenes(name, ncams, ntracks):
    tf = load_tracks(f"tracks/{name}")
    assert tf.frame_count == ncams
    assert tf.bundles.shape[0] == ntracks


def test_skip_frames_remapping():
    tf1 = load_tracks("tracks/koberec-.yaml", skip_frames=1)
    tf2 = load_tracks("tracks/koberec-.yaml", skip_frames=2)
    assert tf2.frame_count == (tf1.frame_count + 1) // 2
    np.testing.assert_allclose(tf2.cameras[1], tf1.cameras[2])


def test_cameras_look_at_bundles():
    """Sanity: most sparse bundles project inside the frustum of enabled cams."""
    tf = load_tracks("tracks/koberec-.yaml")
    from meshrecon.geometry import project_points

    cam0 = tf.cameras[0]
    ndc = np.asarray(project_points(cam0, tf.bundles))
    inside = np.mean((np.abs(ndc[:, 0]) <= 1.2) & (np.abs(ndc[:, 1]) <= 1.2))
    assert inside > 0.8


def test_obj_roundtrip(tmp_path):
    verts = np.array(
        [[0, 0, 0, 1], [1, 0, 0, 1], [0, 1, 0, 1], [2, 2, 2, 2]], dtype=np.float32
    )
    faces = np.array([[0, 1, 2], [1, 2, 3]], dtype=np.int32)
    path = str(tmp_path / "m.obj")
    save_mesh(Mesh(verts, faces), path)
    mesh = read_mesh(path)
    assert mesh.vertices.shape == (4, 4)
    np.testing.assert_allclose(mesh.vertices[3, :3], [1, 1, 1], atol=1e-5)
    np.testing.assert_array_equal(mesh.faces, faces)
    soup = mesh.triangle_soup
    assert soup.shape == (2, 3, 3)


def test_exporter_roundtrip(tmp_path):
    """Our Blender exporter's serializer writes files our parser reads back."""
    import io as _io

    from meshrecon.io.blender_export_tracks import write_tracks_yaml

    proj = [[1.5, 0, 0, 0], [0, 2.0, 0, 0], [0, 0, -1.2, -3.4], [0, 0, -1, 0]]
    buf = _io.StringIO()
    write_tracks_yaml(
        buf,
        {"path": "clip.avi", "width": 640, "height": 480, "fov": 1.1,
         "distortion": (-0.1, 0.05, 0.0), "center_x": 320.0, "center_y": 240.0},
        [{"frame": 1, "near": 2.0, "far": 20.0, "projection": proj,
          "position": [0, 0, 0, 1]},
         {"frame": 2, "near": 2.1, "far": 20.5, "projection": proj,
          "position": [0.1, 0, 0, 1]}],
        [{"bundle": [1, 2, 3, 1], "frames_enabled": [1, 2]},
         {"bundle": [4, 5, 6, 1], "frames_enabled": [2]}],
    )
    path = tmp_path / "scene.yaml"
    path.write_text(buf.getvalue())
    tf = load_tracks(str(path))
    assert tf.width == 640 and tf.frame_count == 2
    assert tf.bundles.shape == (2, 4)
    np.testing.assert_allclose(tf.cameras[0], np.asarray(proj), rtol=1e-6)
    assert tf.bundles_enabled[0] == {0, 1}
    assert tf.bundles_enabled[1] == {1}
    assert abs(tf.distortion[0] + 0.1) < 1e-6


def _pyyaml_read(path):
    """The track file as PyYAML reads it once the two OpenCV quirks are
    handled: the independent reference for read_opencv_yaml."""
    yaml = pytest.importorskip("yaml")

    def matrix(loader, node):
        m = loader.construct_mapping(node, deep=True)
        return np.asarray(m["data"], np.float32).reshape(int(m["rows"]),
                                                        int(m["cols"]))

    class Loader(yaml.SafeLoader):
        pass

    Loader.add_constructor("tag:yaml.org,2002:opencv-matrix", matrix)
    with open(path) as fh:
        lines = fh.read().splitlines()
    if lines and lines[0].startswith("%YAML"):
        lines = lines[1:]
    return yaml.load("\n".join(lines), Loader=Loader)


def _assert_same_tree(a, b, where="doc"):
    if isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray), where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(b, dict):
        assert isinstance(a, dict) and list(a) == list(b), where
        for k in b:
            _assert_same_tree(a[k], b[k], f"{where}.{k}")
    elif isinstance(b, list):
        assert isinstance(a, list) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tree(x, y, f"{where}[{i}]")
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


@pytest.mark.parametrize("name", ["koberec-.yaml", "koberec.yaml",
                                  "koule-tr.yaml", "zatisi.yaml"])
def test_track_parser_matches_pyyaml(name):
    from meshrecon.io.tracks import read_opencv_yaml

    path = f"tracks/{name}"
    _assert_same_tree(read_opencv_yaml(path), _pyyaml_read(path))


def test_track_parser_rejects_unknown_tags(tmp_path):
    from meshrecon.io.tracks import read_opencv_yaml

    path = tmp_path / "bad.yaml"
    path.write_text("%YAML:1.0\nclip:\n   fov: !!binary AAAA\n")
    with pytest.raises(ValueError, match="bad.yaml:3"):
        read_opencv_yaml(str(path))
