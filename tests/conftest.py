"""Test configuration.

Tests run JAX on a virtual 8-device CPU mesh (SURVEY.md §4e): the standard
JAX substitute for multi-device hardware.  The env vars must be set before
jax is first imported, which pytest guarantees by importing conftest first.
"""

import os
import subprocess

# Force CPU with 8 virtual devices BEFORE any jax import.  The config is
# updated after import too, in case jax was imported earlier.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")
# Tests compile small shapes in parallel workers; the persistent compile
# cache (utils/compile_cache.py) would only fill the checkout.
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np
import pytest

REFERENCE_DIR = "/root/reference"


@pytest.fixture(scope="session")
def oracle(tmp_path_factory):
    """Build the C reference binary as a golden oracle (SURVEY.md §4a).

    The sources are compiled straight out of the read-only reference mount —
    nothing is copied into this repository.  Skips if unavailable.
    """
    if not os.path.isdir(REFERENCE_DIR):
        pytest.skip("reference sources not available")
    build = tmp_path_factory.mktemp("oracle")
    binary = build / "lz77_ref"
    srcs = [
        os.path.join(REFERENCE_DIR, f)
        for f in ("main.c", "lz77.c", "tree.c", "bitio.c")
    ]
    # The shipped Makefile is missing -lm (SURVEY.md §2 component 8).
    res = subprocess.run(
        ["gcc", "-O2", "-o", str(binary), *srcs, "-lm", "-I", REFERENCE_DIR],
        capture_output=True,
        text=True,
    )
    if res.returncode != 0:
        pytest.skip(f"could not build reference oracle: {res.stderr}")
    return OracleRunner(str(binary), str(build))


class OracleRunner:
    def __init__(self, binary: str, workdir: str):
        self.binary = binary
        self.workdir = workdir
        self._n = 0

    def _run(self, mode: str, data: bytes, la=None, sb=None) -> bytes:
        self._n += 1
        inp = os.path.join(self.workdir, f"in{self._n}")
        out = os.path.join(self.workdir, f"out{self._n}")
        with open(inp, "wb") as f:
            f.write(data)
        cmd = [self.binary, mode, "-i", inp, "-o", out]
        if la is not None:
            cmd += ["-l", str(la)]
        if sb is not None:
            cmd += ["-s", str(sb)]
        subprocess.run(cmd, check=True, capture_output=True)
        with open(out, "rb") as f:
            result = f.read()
        os.unlink(inp)
        os.unlink(out)
        return result

    def encode(self, data: bytes, la=None, sb=None) -> bytes:
        return self._run("-c", data, la, sb)

    def decode(self, stream: bytes) -> bytes:
        return self._run("-d", stream)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0xC57D)


def make_text(rng, n: int) -> bytes:
    """Synthetic word-salad text (the baseline's text-like input class)."""
    words = [
        rng.integers(97, 123, size=rng.integers(2, 9), dtype=np.uint8).tobytes()
        for _ in range(199)
    ]
    parts, total = [], 0
    while total < n:
        w = words[int(rng.integers(0, len(words)))]
        parts.append(w + b" ")
        total += len(w) + 1
    return b"".join(parts)[:n]


CORPUS_SMALL = {
    "empty": lambda rng: b"",
    "one": lambda rng: b"A",
    "fourteen": lambda rng: b"abcdabcdabcdab",
    "zeros": lambda rng: b"\x00" * 3000,
    "runs": lambda rng: b"ab" * 1500 + b"c" * 500,
    "text": lambda rng: make_text(rng, 4096),
    "random": lambda rng: rng.integers(0, 256, 2048, dtype=np.uint8).tobytes(),
    "alpha_cycle": lambda rng: bytes(i % 251 for i in range(5000)),
}

