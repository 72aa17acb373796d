"""Streamed device decode (codec.decode_file_device).

The stream is read in token chunks and replayed through the XLA decoder
with the window tail carried on the device between chunks, so a stream of
any size decodes through the device at bounded host memory.  These tests
pin equality with the input across widths (byte-aligned and not), chunk
geometries, and corrupt-stream rejection.
"""

import numpy as np
import pytest

from lz77_tpu import bitio, native, spec
from lz77_tpu.models import codec

from conftest import make_text


def _roundtrip(tmp_path, data, params, **kw):
    stream = native.encode(data, params)
    sp = tmp_path / "s.lz"
    sp.write_bytes(stream)
    op = tmp_path / "s.out"
    st = codec.DecodeStats()
    tot = codec.decode_file_device(str(sp), str(op), stats=st, **kw)
    assert st.backend == "device-xla-streamed"
    assert tot == len(data)
    assert op.read_bytes() == data


@pytest.mark.parametrize(
    "la,sb",
    [(15, 4095), (15, 15), (9, 511)],  # 24-bit, 16-bit, 21-bit tokens
)
def test_device_stream_roundtrip(tmp_path, rng, la, sb):
    p = spec.Params(la=la, sb=sb)
    data = (
        make_text(rng, 60_000)
        + b"\x00" * 30_000
        + np.asarray(rng.integers(0, 256, 20_000, dtype=np.uint8)).tobytes()
    )
    _roundtrip(tmp_path, data, p, chunk_tokens=4096, read_tokens=8192)


def test_device_stream_tiny_stages(tmp_path, rng):
    """Small chunks and reads: many device-tail handoffs, and file reads
    that split a chunk's worth of tokens."""
    p = spec.Params(la=15, sb=255)
    data = b"ab" * 3_000 + make_text(rng, 20_000) + b"\x00" * 9_000
    _roundtrip(tmp_path, data, p, chunk_tokens=1024, read_tokens=1528)


def test_device_stream_edge_inputs(tmp_path):
    for data in (b"", b"x", b"\x00" * 14):
        _roundtrip(tmp_path, data, spec.Params())


def test_device_stream_rejects_corrupt(tmp_path):
    p = spec.Params()
    # offset beyond decoded history
    stream = bitio.build_stream(
        np.array([0, 300], np.int64), np.array([0, 3], np.int64),
        np.array([65, 66], np.int64), p,
    )
    sp = tmp_path / "c.lz"
    sp.write_bytes(stream)
    with pytest.raises(ValueError, match="corrupt"):
        codec.decode_file_device(str(sp), str(tmp_path / "o"))
    # truncated header
    sp.write_bytes(b"\xff\x0f")
    with pytest.raises(ValueError, match="header|corrupt"):
        codec.decode_file_device(str(sp), str(tmp_path / "o"))


def test_decode_file_routes_device_stream(tmp_path, rng):
    data = make_text(rng, 30_000)
    stream = native.encode(data, spec.Params())
    sp = tmp_path / "r.lz"
    sp.write_bytes(stream)
    st = codec.DecodeStats()
    n = codec.decode_file(str(sp), str(tmp_path / "r.out"),
                          backend="device", stats=st)
    assert n == len(data)
    assert st.backend == "device-xla-streamed"
    assert (tmp_path / "r.out").read_bytes() == data
