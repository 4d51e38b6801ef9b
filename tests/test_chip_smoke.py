"""chip_smoke.py refuses to run anywhere but on a GPU, and prints no result
when it does not run: no CPU fallback, and no result without the
program."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[1]


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _printed_result(stdout):
    for line in stdout.splitlines():
        try:
            if isinstance(json.loads(line), dict):
                return True
        except ValueError:
            pass
    return False


def test_fails_without_a_gpu():
    proc = _run(_ROOT, _ROOT / "chip_smoke.py")
    assert proc.returncode != 0
    assert "no GPU" in proc.stderr
    assert not _printed_result(proc.stdout)


def test_fails_without_the_program(tmp_path):
    shutil.copy(_ROOT / "chip_smoke.py", tmp_path)
    proc = _run(tmp_path, tmp_path / "chip_smoke.py")
    assert proc.returncode != 0
    assert not _printed_result(proc.stdout)
