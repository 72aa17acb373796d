#!/usr/bin/env python
"""Smoke run of the codec on a GPU, through the CLI a user would call.

    python chip_smoke.py                 # one GPU: every phase below
    python chip_smoke.py --four-gpus     # four GPUs: the sharded phase only

One GPU:
  1. device  — the card's name and power limit (nvidia-smi) and
               jax.devices(); anything but a GPU stops the run.
  2. input   — a >= 64 MiB file made from the six Silesia-class generators
               of ``lz77_tpu.corpus`` in equal shares, from ``--seed``.
  3. encode  — ``-c --backend jax`` at the defaults (-l 15 -s 4095) with
               ``--pipeline host``, ``fused`` and ``sharded`` (one-device
               mesh); each stream must equal ``native.encode``'s byte for
               byte.
  4. decode  — ``-d`` (native streamed) and ``-d --decode-backend device``;
               each result must equal the input byte for byte.
  5. wide    — a 1 MiB sample at ``-l 255 -s 65535`` (32-bit tokens) through
               ``--pipeline fused`` and both decoders, same checks.
Four GPUs: ``--pipeline sharded`` at ``--mesh 4x1`` (data axis, default
matcher) and ``--mesh 2x2`` (data x distance axis, ``--matcher bitplane``:
its ranged sweep splits the distances, combined with ``pmax``), each stream
checked against ``native.encode`` and decoded back, and every card's peak
memory checked to show it did work.

Each encode runs once on the first MiB (compilation) and then on the whole
input; both times are printed with the CLI's ``--report``.  Any failed
check exits non-zero before the last line, which is one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

MIB = 1 << 20


def result_line(devices) -> str:
    """The last line of a passing run: the device as JAX reports it."""
    return json.dumps({
        "ok": True,
        "device": {
            "platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices),
        },
    })


def card_lines() -> str:
    """``name, power.limit`` of each card, one line per card, exactly as
    nvidia-smi reports them."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return res.stdout.strip() or res.stderr.strip()


def fail(msg: str):
    raise SystemExit(f"FAIL: {msg}")


def sample(data: bytes, n: int, classes: int = 6) -> bytes:
    """``n`` bytes taken as equal runs from the start of each class."""
    share = len(data) // classes
    run = -(-n // classes)
    return b"".join(data[i * share : i * share + run] for i in range(classes))


def run_cli(argv: list[str]) -> dict:
    """``lz77_tpu.cli.main(argv)`` in this process; returns its --report."""
    from lz77_tpu import cli

    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli.main(argv + ["--report"])
    dt = time.perf_counter() - t0
    text = err.getvalue()
    if rc != 0:
        sys.stderr.write(text)
        fail(f"cli exited {rc}: {' '.join(argv)}")
    rep = json.loads(text.strip().splitlines()[-1])
    rep["wall_s"] = dt
    return rep


def show(phase: str, rep: dict, nbytes: int) -> None:
    keys = ("pipeline", "matcher", "decode_backend", "platform",
            "device_kind", "device_count", "ratio", "phases", "h2d_bytes",
            "d2h_bytes", "peak_rss_mb")
    line = {"phase": phase, "seconds": rep["wall_s"],
            "mb_per_s": nbytes / rep["wall_s"] / 1e6}
    line.update({k: rep[k] for k in keys if k in rep})
    print(json.dumps(line), flush=True)


def same_file(path: str, want: bytes, what: str) -> None:
    with open(path, "rb") as f:
        got = f.read()
    if got != want:
        first = next(
            (i for i, (a, b) in enumerate(zip(got, want)) if a != b),
            min(len(got), len(want)),
        )
        fail(f"{what}: {len(got)} bytes vs {len(want)} expected, first "
             f"difference at byte {first}")
    print(f"identical: {what} ({len(got)} bytes)", flush=True)


def encode_phase(td, name, data, ref, flags, head=MIB) -> str:
    """Encode ``data`` through the CLI (after a compiling run on its head);
    check the stream against ``ref``; return the stream's path."""
    src = os.path.join(td, f"{name}.in")
    out = os.path.join(td, f"{name}.lz")
    with open(src, "wb") as f:
        f.write(data[:head])
    show(f"{name} compile+run {head} B",
         run_cli(["-c", "-i", src, "-o", out] + flags), head)
    with open(src, "wb") as f:
        f.write(data)
    show(f"{name} {len(data)} B",
         run_cli(["-c", "-i", src, "-o", out] + flags), len(data))
    same_file(out, ref, f"{name} stream vs native.encode")
    os.unlink(src)
    return out


def decode_phase(td, name, stream, data) -> None:
    for label, flags in (("native", []),
                         ("device", ["--decode-backend", "device"])):
        out = os.path.join(td, f"{name}.{label}.out")
        show(f"{name} decode {label}",
             run_cli(["-d", "-i", stream, "-o", out] + flags), len(data))
        same_file(out, data, f"{name} {label} decode vs input")
        os.unlink(out)


def one_gpu(td, data: bytes, wide: bytes) -> None:
    from lz77_tpu import native, spec

    t0 = time.perf_counter()
    ref = native.encode(data, spec.Params())
    print(f"native.encode reference: {len(ref)} B in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    stream = None
    for pipe in ("host", "fused", "sharded"):
        flags = ["--backend", "jax", "--pipeline", pipe]
        if pipe == "sharded":
            flags += ["--mesh", "1x1"]
        stream = encode_phase(td, f"default-{pipe}", data, ref, flags)
    decode_phase(td, "default", stream, data)

    wide_params = ["-l", "255", "-s", "65535"]
    ref = native.encode(wide, spec.Params(la=255, sb=65535))
    stream = encode_phase(
        td, "wide-fused", wide, ref,
        wide_params + ["--backend", "jax", "--pipeline", "fused"],
        head=len(wide) // 4,
    )
    decode_phase(td, "wide", stream, wide)


def four_gpus(td, data: bytes) -> None:
    import jax

    from lz77_tpu import native, spec

    devices = jax.devices()
    if len(devices) < 4:
        fail(f"--four-gpus needs 4 devices, JAX sees {len(devices)}")
    ref = native.encode(data, spec.Params())
    for mesh, extra in (("4x1", []), ("2x2", ["--matcher", "bitplane"])):
        stream = encode_phase(
            td, f"sharded-{mesh}", data, ref,
            ["--backend", "jax", "--pipeline", "sharded", "--mesh", mesh]
            + extra,
        )
        out = os.path.join(td, "sharded.out")
        show(f"sharded-{mesh} decode native",
             run_cli(["-d", "-i", stream, "-o", out]), len(data))
        same_file(out, data, f"sharded-{mesh} decode vs input")
        os.unlink(out)
    peaks = [d.memory_stats()["peak_bytes_in_use"] for d in devices[:4]]
    print(json.dumps({"peak_bytes_in_use": peaks}), flush=True)
    if min(peaks) < MIB:
        fail(f"a card did no work: peak bytes in use {peaks}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the four-GPU sharded phase")
    ap.add_argument("--mb", type=int, default=64,
                    help="input size in MiB (default 64)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the input generators")
    args = ap.parse_args(argv)

    print(card_lines(), flush=True)
    import jax

    devices = jax.devices()
    print(f"jax {jax.__version__} devices: {devices}", flush=True)
    if devices[0].platform != "gpu":
        fail(f"no GPU: JAX runs on {devices[0].platform}")

    from lz77_tpu.utils import compile_cache

    print(f"compile cache: {compile_cache.enable()}", flush=True)
    t0 = time.perf_counter()
    from lz77_tpu import corpus

    data = corpus.silesia_mix(args.mb * MIB, args.seed)
    print(f"input: {len(data)} B in {time.perf_counter() - t0:.3f} s",
          flush=True)
    with tempfile.TemporaryDirectory() as td:
        if args.four_gpus:
            four_gpus(td, data)
        else:
            one_gpu(td, data, sample(data, MIB))
    print(card_lines(), flush=True)
    print(result_line(jax.devices()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
