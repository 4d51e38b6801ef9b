"""Where the persistent compilation cache goes.

JAX_COMPILATION_CACHE_DIR wins when it is set; otherwise the cache sits at
one fixed, gitignored directory inside the checkout (the path is part of
the cache key, so it must not move), and no other code sets a path.
"""

from pathlib import Path

import jax
import pytest

from meshrecon.utils import compile_cache

_ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def config_updates(monkeypatch):
    """Record jax.config.update calls instead of applying them (turning the
    cache on would make every later test in this worker write to it)."""
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.__setitem__(name, value))
    return calls


def test_env_var_is_honoured(monkeypatch, config_updates, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert "jax_compilation_cache_dir" not in config_updates


def test_default_is_fixed_inside_the_checkout(monkeypatch, config_updates):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = compile_cache.enable_compile_cache()
    assert got == config_updates["jax_compilation_cache_dir"]
    assert Path(got) == _ROOT / ".jax_cache"
    ignored = (_ROOT / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def test_no_other_code_sets_a_cache_path():
    sources = [p for d in ("meshrecon", "tools")
               for p in (_ROOT / d).rglob("*.py")]
    sources += [_ROOT / n for n in ("bench.py", "chip_smoke.py",
                                    "__graft_entry__.py")]
    setters = sorted(str(p.relative_to(_ROOT)) for p in sources
                     if "jax_compilation_cache_dir" in p.read_text())
    assert setters == ["meshrecon/utils/compile_cache.py"]
