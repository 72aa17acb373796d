"""Device decode through the XLA decoder (models/decoder.py).

``codec.decode_bytes(backend='device')`` replays tokens by pointer doubling
on the device, in token chunks whose window tail stays on the device.  These
tests assert it is byte-exact against the input on every input class —
including the overlapping-copy (off < len) runs the reference leans on, and
every offset width up to sb=65535 — and that the route is recorded and never
swapped silently.
"""

import warnings

import numpy as np
import pytest

from lz77_tpu import bitio, native, spec
from lz77_tpu.models import codec, decoder

from conftest import make_text


def _wide_offsets(rng):
    """A shuffled page repeated ~48k later: offsets far beyond 13 bits."""
    page = rng.integers(0, 256, 48_000, dtype=np.uint8).tobytes()
    return page + make_text(rng, 8_000) + page


CASES = {
    "text": (lambda rng: make_text(rng, 100_000), spec.Params()),
    "zeros": (lambda rng: b"\x00" * 50_000, spec.Params()),  # off < len
    "period2": (lambda rng: b"ab" * 25_000, spec.Params()),
    "random": (
        lambda rng: rng.integers(0, 256, 30_000, dtype=np.uint8).tobytes(),
        spec.Params(),
    ),
    "one": (lambda rng: b"A", spec.Params()),
    "empty": (lambda rng: b"", spec.Params()),
    "nondefault": (lambda rng: make_text(rng, 40_000),
                   spec.Params(la=32, sb=255)),
    "max_window": (_wide_offsets, spec.Params(sb=65535)),
    "tiny_tokens": (
        lambda rng: bytes(rng.integers(0, 4, 12_000, dtype=np.uint8)),
        spec.Params(la=3, sb=255),
    ),
    "text_120k": (lambda rng: make_text(rng, 120_000), spec.Params()),
    "zeros_60k": (lambda rng: b"\x00" * 60_000, spec.Params()),
    "off2": (lambda rng: b"ab" * 20_000, spec.Params()),
    "off3": (lambda rng: b"abc" * 12_000, spec.Params()),
    "off4": (lambda rng: b"abcd" * 12_000, spec.Params()),
    "off7": (lambda rng: b"abcdefg" * 7_000, spec.Params()),
    "wide": (lambda rng: make_text(rng, 120_000),
             spec.Params(la=15, sb=65535)),
    "tiny": (lambda rng: b"x", spec.Params()),
}


@pytest.mark.parametrize("name", list(CASES))
def test_device_decode_matches_input(name, rng):
    make, params = CASES[name]
    data = make(rng)
    stream = native.encode(data, params)
    if name == "max_window":
        _, off, _, _ = bitio.parse_stream(stream)
        assert int(off.max()) > (1 << 13)  # wide offsets actually present
    st = codec.DecodeStats()
    assert codec.decode_bytes(stream, backend="device", stats=st) == data
    assert st.backend == "device-xla"


def test_device_decode_c_oracle_stream(oracle, rng):
    """Decode a stream the C reference encoder produced."""
    data = make_text(rng, 60_000)
    assert codec.decode_bytes(oracle.encode(data), backend="device") == data


def test_codec_device_dispatch_walk(rng):
    """backend='device' runs the XLA decoder and records it."""
    data = make_text(rng, 30_000)
    stream = codec.encode_bytes(data, spec.Params())
    st = codec.DecodeStats()
    out = codec.decode_bytes(stream, backend="device", stats=st)
    assert out == data
    assert st.backend == "device-xla"
    assert st.requested == "device"
    assert st.output_bytes == len(data)


def test_codec_device_dispatch_max_window_walk(rng):
    """sb=65535 (the CLI maximum, 16-bit offsets) decodes on the device
    without a warning: one decoder covers the full reference window range."""
    data = make_text(rng, 20_000)
    stream = codec.encode_bytes(data, spec.Params(sb=65535))
    st = codec.DecodeStats()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = codec.decode_bytes(stream, backend="device", stats=st)
    assert out == data
    assert st.backend == "device-xla"


def test_codec_device_dispatch_wide_window_fallback(rng, monkeypatch):
    """A failing device decode raises: there is no fallback that would hand
    a benchmarking caller another backend's numbers."""
    stream = codec.encode_bytes(make_text(rng, 5_000), spec.Params())

    def broken(data, *a, **k):
        raise RuntimeError("device decode failed")

    monkeypatch.setattr(decoder, "decode_stream", broken)
    st = codec.DecodeStats()
    with pytest.raises(RuntimeError, match="device decode failed"):
        codec.decode_bytes(stream, backend="device", stats=st)
    assert st.backend == ""
    with pytest.raises(ValueError, match="unknown decode backend"):
        codec.decode_bytes(stream, backend="walk")


def test_codec_device_dispatch_cpu_guard(rng):
    """The CPU platform (this suite) runs the same XLA decoder as a GPU:
    the device route has no platform branch."""
    import jax

    assert jax.devices()[0].platform == "cpu"
    data = make_text(rng, 20_000)
    stream = codec.encode_bytes(data, spec.Params())
    st = codec.DecodeStats()
    assert codec.decode_bytes(stream, backend="device", stats=st) == data
    assert st.backend == "device-xla"
