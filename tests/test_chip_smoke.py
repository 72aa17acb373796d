"""chip_smoke.py's contract where there is no GPU, and the compile-cache
location helper it shares with the CLI and bench.py."""

import json
import os
import shutil
import subprocess
import sys

import jax

from lz77_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_smoke(cwd, env=None):
    return subprocess.run(
        [sys.executable, os.path.join(cwd, "chip_smoke.py"), "--mb", "1"],
        capture_output=True, text=True, timeout=300, cwd=cwd,
        env=dict(os.environ, **(env or {})),
    )


def test_chip_smoke_fails_without_gpu():
    """On the CPU the smoke run exits non-zero and prints no result."""
    res = _run_smoke(REPO, {"JAX_PLATFORMS": "cpu"})
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "no GPU" in res.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo fails
    too, printing no result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "chip_smoke.py"], capture_output=True, text=True,
        timeout=300, cwd=tmp_path, env=env,
    )
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_result_line_keys():
    """The last line holds exactly the contract's keys, as JAX reports the
    device."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    devices = jax.devices()
    line = json.loads(chip_smoke.result_line(devices))
    assert line == {
        "ok": True,
        "device": {
            "platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices),
        },
    }


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    old = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert compile_cache.enable() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_default_is_checkout(monkeypatch):
    old = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(REPO, ".jax_cache")
    try:
        assert compile_cache.cache_dir() == want
        assert compile_cache.enable() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
