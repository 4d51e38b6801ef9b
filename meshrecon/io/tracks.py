"""Parser for the OpenCV-FileStorage YAML dialect written by Blender's
``io_export_tracks.py`` exporter.

The format (see reference ``io_export_tracks.py:40-96`` and samples in
``tracks/*.yaml``) is a small subset of YAML 1.0 with two OpenCV quirks:

- a ``%YAML:1.0`` directive (note the colon — not valid YAML),
- ``!!opencv-matrix`` tagged mappings ``{rows, cols, dt, data}``.

Structure: ``clip: {path, width, height, fov, distortion[k1,k2,k3],
center-x, center-y}``, ``camera: [{frame, near, far, projection 4x4,
position 4x1}]``, ``tracks: [{bundle 4x1, frames-enabled[]}]``.
``frame`` and ``frames-enabled`` indices are 1-based; ``skip_frames``
remapping follows configuration.cpp:183-196,205-218.

The subset is parsed here directly: block mappings and ``- `` sequences
by indentation, one-line ``[a, b, ...]`` flow lists, and plain or quoted
scalars. Anything else in a track file is an error, not a guess.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

_MATRIX_TAG = "!!opencv-matrix"


def _scalar(text: str, where: str):
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "\"'":
        return text[1:-1]
    if text.startswith("[") or text.startswith("{") or text.startswith("!"):
        raise ValueError(f"unsupported YAML value {text!r} ({where})")
    for conv in (int, float):
        try:
            return conv(text)
        except ValueError:
            pass
    return text


def _value(text: str, where: str):
    text = text.strip()
    if text.startswith("["):
        if not text.endswith("]"):
            raise ValueError(f"unterminated flow list ({where})")
        body = text[1:-1].strip()
        return [_scalar(t, where) for t in body.split(",")] if body else []
    return _scalar(text, where)


def _matrix(mapping: dict, where: str) -> np.ndarray:
    rows, cols = int(mapping["rows"]), int(mapping["cols"])
    data = np.asarray(mapping["data"], dtype=np.float32)
    if data.size != rows * cols:
        raise ValueError(f"opencv-matrix data has {data.size} values, "
                         f"expected {rows}x{cols} ({where})")
    return data.reshape(rows, cols)


class _Parser:
    """Indentation-driven recursive descent over (line number, indent,
    content) triples."""

    def __init__(self, text: str, path: str):
        self.path = path
        self.lines = []
        for no, raw in enumerate(text.splitlines(), 1):
            content = raw.strip()
            if not content or content.startswith("#"):
                continue
            if no == 1 and content.startswith("%YAML"):
                continue  # the malformed %YAML:1.0 directive
            self.lines.append((no, len(raw) - len(raw.lstrip(" ")), content))
        self.i = 0

    def where(self, no: int) -> str:
        return f"{self.path}:{no}"

    def block(self, indent: int):
        """The mapping or sequence whose entries sit at column `indent`."""
        if self.lines[self.i][2].startswith("- ") or self.lines[
                self.i][2] == "-":
            return self.sequence(indent)
        return self.mapping(indent, {})

    def sequence(self, indent: int) -> list:
        items = []
        while self.i < len(self.lines):
            no, ind, content = self.lines[self.i]
            if ind != indent or not content.startswith("-"):
                break
            rest = content[1:].lstrip(" ")
            col = ind + (len(content) - len(rest))
            if ":" not in rest:
                self.i += 1
                items.append(_value(rest, self.where(no)))
                continue
            # "- key: value" opens a mapping whose keys sit at column `col`
            self.lines[self.i] = (no, col, rest)
            items.append(self.mapping(col, {}))
        return items

    def mapping(self, indent: int, out: dict) -> dict:
        while self.i < len(self.lines):
            no, ind, content = self.lines[self.i]
            if ind < indent:
                break
            if ind > indent or content.startswith("-"):
                raise ValueError(f"unexpected indentation ({self.where(no)})")
            key, sep, rest = content.partition(":")
            if not sep:
                raise ValueError(f"expected 'key: value' ({self.where(no)})")
            key, rest = key.strip(), rest.strip()
            self.i += 1
            tag = None
            if rest.startswith("!!"):
                tag, _, rest = rest.partition(" ")
                if tag != _MATRIX_TAG:
                    raise ValueError(f"unsupported tag {tag} "
                                     f"({self.where(no)})")
            if rest:
                out[key] = _value(rest, self.where(no))
                continue
            nxt = self.lines[self.i] if self.i < len(self.lines) else None
            if nxt is None or nxt[1] < indent or (
                    nxt[1] == indent and not nxt[2].startswith("-")):
                value = None  # empty value (e.g. a section with no entries)
            else:
                value = self.block(nxt[1])
            if tag == _MATRIX_TAG:
                value = _matrix(value or {}, self.where(no))
            out[key] = value
        return out


def read_opencv_yaml(path: str) -> dict:
    """Parse one OpenCV FileStorage YAML file into dicts, lists, scalars and
    float32 arrays (for ``!!opencv-matrix`` nodes)."""
    with open(path, "r") as fh:
        parser = _Parser(fh.read(), path)
    if not parser.lines:
        return {}
    doc = parser.block(parser.lines[0][1])
    if parser.i != len(parser.lines):
        no = parser.lines[parser.i][0]
        raise ValueError(f"unexpected indentation ({parser.where(no)})")
    return doc


@dataclasses.dataclass
class TrackFile:
    """In-memory form of one exported scene calibration.

    Arrays are kept exactly as parsed; frame-index remapping for
    ``skip_frames`` happens here (like configuration.cpp:183-218) so all
    downstream indices are 0-based and already subsampled.
    """

    clip_path: str  # resolved relative to the YAML's directory
    width: int
    height: int
    fov: float
    distortion: np.ndarray  # (3,) [k1, k2, k3]
    center_x: float
    center_y: float
    cameras: np.ndarray  # (F, 4, 4) float32 projection per tracked frame
    near: np.ndarray  # (F,)
    far: np.ndarray  # (F,)
    camera_valid: np.ndarray  # (F,) bool: frame had a camera entry
    bundles: np.ndarray  # (N, 4) float32 homogeneous sparse points
    bundles_enabled: list  # list of N sets of 0-based frame indices

    @property
    def frame_count(self) -> int:
        return int(self.cameras.shape[0])


def load_tracks(path: str, skip_frames: int = 1) -> TrackFile:
    """Load and validate a track YAML. Fail-fast like configuration.cpp:134-142."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"Cannot read file {path}")
    doc = read_opencv_yaml(path)
    if not isinstance(doc, dict) or "clip" not in doc:
        raise ValueError(f"No clip section in configuration YAML {path}")

    clip = doc["clip"]
    width, height = int(clip["width"]), int(clip["height"])
    distortion = np.asarray(clip.get("distortion", [0.0, 0.0, 0.0]), dtype=np.float32)
    clip_path = os.path.join(os.path.dirname(os.path.abspath(path)), clip["path"])

    cam_entries = doc.get("camera", []) or []
    # Largest (1-based) frame index after skip remapping decides array length,
    # mirroring trackedFrameCount in configuration.cpp:204-224.
    tracked = 0
    parsed = []
    for entry in cam_entries:
        fi = int(entry["frame"])
        assert fi > 0, "frame indices are 1-based"
        fi -= 1
        if fi % skip_frames:
            continue
        fi //= skip_frames
        parsed.append((fi, entry))
        tracked = max(tracked, fi + 1)

    cameras = np.zeros((tracked, 4, 4), dtype=np.float32)
    near = np.zeros(tracked, dtype=np.float32)
    far = np.zeros(tracked, dtype=np.float32)
    valid = np.zeros(tracked, dtype=bool)
    for fi, entry in parsed:
        proj = np.asarray(entry["projection"], dtype=np.float32)
        if proj.shape != (4, 4):
            raise ValueError(f"projection for frame {fi} is {proj.shape}, not 4x4")
        cameras[fi] = proj
        near[fi] = float(entry["near"])
        far[fi] = float(entry["far"])
        valid[fi] = True
    if not np.all((near[valid] > 0) & (far[valid] > 0)):
        raise ValueError("near/far values must be positive for tracked frames")

    bundles = []
    enabled = []
    for track in doc.get("tracks", []) or []:
        bundle = np.asarray(track["bundle"], dtype=np.float32).reshape(-1)
        if bundle.shape[0] != 4:
            raise ValueError("bundle must be a 4-vector")
        frames_enabled = track.get("frames-enabled", []) or []
        remapped = set()
        for f in frames_enabled:
            f0 = int(f) - 1
            if f0 % skip_frames == 0:
                remapped.add(f0 // skip_frames)
        bundles.append(bundle)
        enabled.append(remapped)
    bundles_arr = (
        np.stack(bundles).astype(np.float32)
        if bundles
        else np.zeros((0, 4), dtype=np.float32)
    )

    return TrackFile(
        clip_path=clip_path,
        width=width,
        height=height,
        fov=float(clip.get("fov", 0.0)),
        distortion=distortion,
        center_x=float(clip.get("center-x", width / 2.0)),
        center_y=float(clip.get("center-y", height / 2.0)),
        cameras=cameras,
        near=near,
        far=far,
        camera_valid=valid,
        bundles=bundles_arr,
        bundles_enabled=enabled,
    )
