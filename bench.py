#!/usr/bin/env python
"""Device benchmark: per-matcher batch times and fused encode throughput.

    python bench.py

Runs on a GPU only: with no GPU it exits non-zero before measuring.  Every
line it prints is one JSON object and names the card; the card's name and
power limit (nvidia-smi) come first.

* ``batch`` lines: one batch at the pipeline's block shape (8 blocks of
  64 KiB of the Silesia-class mix, ``corpus.silesia_mix``) through the match
  phase alone (``encoder.match_blocks``) and through the whole fused step
  (``fused.encode_batch_device``: match, parse, pack), for each XLA matcher.
  Times are the median of ``REPS`` runs that end in ``block_until_ready``;
  the compile time of the first call is reported apart.  The wide shape
  (-l 255 -s 65535) runs only the chunked matcher: the bit-plane and sorted
  formulations take many minutes to compile at depth 254.
* ``e2e`` line: ``encode_bytes_fused`` and the device decoder on 16 MiB of
  the same mix, best of three, after a warm-up; the stream is checked
  against ``native.encode`` and the decode against the input before any
  number is printed.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

REPS = 7
MIB = 1 << 20


def card() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return res.stdout.strip()


def timed(fn, reps: int = REPS):
    """(compile_s, median_s) of ``fn``; each call ends in block_until_ready."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return first, statistics.median(ts)


def batch_times(dev: dict, la: int, sb: int, matchers) -> None:
    import jax.numpy as jnp

    from lz77_tpu import corpus, spec
    from lz77_tpu.models import codec, encoder, fused

    params = spec.Params(la=la, sb=sb)
    B, G = codec.DEFAULT_BLOCK_SIZE, codec.DEFAULT_BATCH_BLOCKS
    x = np.frombuffer(corpus.silesia_mix(2 * G * B), np.uint8)
    # the second batch of the stream: every block has its full halo
    arrays = codec._batch_inputs(
        x, x.shape[0], G, G, G, B, params.d_limit, params.len_limit
    )
    args = [jnp.asarray(a) for a in arrays]
    for m in matchers:
        c_match, t_match = timed(lambda: encoder.match_blocks(
            *args, la=la, sb=sb, matcher=m))
        c_step, t_step = timed(lambda: fused.encode_batch_device(
            *args, jnp.int32(G * B), jnp.int32(0), la=la, sb=sb, matcher=m))
        print(json.dumps({
            "kind": "batch", "la": la, "sb": sb, "block": B, "blocks": G,
            "matcher": m, "match_s": t_match, "fused_step_s": t_step,
            "match_mb_s": G * B / t_match / 1e6,
            "fused_step_mb_s": G * B / t_step / 1e6,
            "compile_match_s": c_match, "compile_step_s": c_step, **dev,
        }), flush=True)


def e2e(dev: dict) -> None:
    from lz77_tpu import corpus, native, spec
    from lz77_tpu.models import codec, fused

    params = spec.Params()
    data = corpus.silesia_mix(16 * MIB)
    stream = fused.encode_bytes_fused(data[:MIB], params)  # compile
    stream = fused.encode_bytes_fused(data, params)
    if stream != native.encode(data, params):
        raise SystemExit("FAIL: fused stream differs from native.encode")
    if codec.decode_bytes(stream, backend="device") != data:
        raise SystemExit("FAIL: device decode differs from the input")
    t_enc = t_dec = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        fused.encode_bytes_fused(data, params)
        t_enc = min(t_enc, time.perf_counter() - t0)
        t0 = time.perf_counter()
        codec.decode_bytes(stream, backend="device")
        t_dec = min(t_dec, time.perf_counter() - t0)
    print(json.dumps({
        "kind": "e2e", "input_bytes": len(data),
        "ratio": len(stream) / len(data),
        "encode_fused_mb_s": len(data) / t_enc / 1e6,
        "decode_device_mb_s": len(data) / t_dec / 1e6, **dev,
    }), flush=True)


def main() -> int:
    import jax

    from lz77_tpu.utils import compile_cache

    d = jax.devices()[0]
    if d.platform != "gpu":
        print(f"no GPU: JAX runs on {d.platform}", file=sys.stderr)
        return 1
    compile_cache.enable()
    dev = {"card": card(), "platform": d.platform,
           "device_kind": d.device_kind}
    print(json.dumps(dev), flush=True)
    batch_times(dev, 15, 4095, ("bitplane", "chunked", "sorted"))
    batch_times(dev, 255, 65535, ("chunked",))
    e2e(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
