"""End-to-end JAX codec tests: blocking, halos, oracle compatibility."""

import numpy as np
import pytest

from lz77_tpu import bitio, spec
from lz77_tpu.models import codec, spec_np

from conftest import CORPUS_SMALL, make_text


@pytest.mark.parametrize("name", CORPUS_SMALL)
def test_roundtrip_small_blocks(name, rng):
    """Small blocks + halos across many boundaries must roundtrip."""
    data = CORPUS_SMALL[name](rng)
    p = spec.Params(la=15, sb=255)
    stream = codec.encode_bytes(data, p, block_size=512, batch_blocks=3)
    assert codec.decode_bytes(stream) == data


@pytest.mark.parametrize("name", ["text", "runs", "zeros", "random"])
def test_jax_stream_is_c_decodable(name, rng, oracle):
    data = CORPUS_SMALL[name](rng)
    p = spec.Params(la=15, sb=255)
    stream = codec.encode_bytes(data, p, block_size=512)
    assert oracle.decode(stream) == data


@pytest.mark.parametrize("name", ["text", "runs", "random"])
def test_jax_decodes_c_streams(name, rng, oracle):
    data = CORPUS_SMALL[name](rng)
    stream = oracle.encode(data)
    assert codec.decode_bytes(stream) == data


@pytest.mark.parametrize("name", ["text", "runs", "zeros"])
def test_size_beats_reference(name, rng, oracle):
    """Halo'd exhaustive matching must never lose to the BST reference."""
    data = CORPUS_SMALL[name](rng)
    p = spec.Params(la=15, sb=255)
    ours = codec.encode_bytes(data, p, block_size=512)
    ref = oracle.encode(data, la=15, sb=255)
    assert len(ours) <= len(ref)


def test_matches_spec_model_exactly(rng):
    """Block decomposition with halo must emit the identical token stream
    as the whole-input numpy spec (same matcher semantics, same tie-break)."""
    data = make_text(rng, 3000)
    p = spec.Params(la=15, sb=255)
    ours = codec.encode_bytes(data, p, block_size=512, batch_blocks=2)
    theirs = spec_np.encode(data, p)
    assert ours == theirs


def test_empty_and_tiny(rng):
    for data in [b"", b"x", b"ab", b"aaa"]:
        stream = codec.encode_bytes(data, block_size=256)
        assert codec.decode_bytes(stream) == data


def test_stats_report(rng):
    data = CORPUS_SMALL["text"](rng)
    stats = codec.EncodeStats()
    stream = codec.encode_bytes(
        data, spec.Params(la=15, sb=255), block_size=1024, stats=stats
    )
    assert stats.input_bytes == len(data)
    assert stats.output_bytes == len(stream)
    assert stats.blocks == -(-len(data) // 1024)
    assert stats.tokens == spec.token_count(
        len(stream) - spec.HEADER_BYTES, spec.Params(la=15, sb=255).width
    )


def test_large_la_bitplane_native(rng):
    """la > 33 runs the bit-plane family DIRECTLY (round 3 removed the
    la <= 33 cap and the auto-routing fallback with it): identical stream
    to the chunked matcher, no warning (the reference accepts -l up to
    255, main.c:35)."""
    import warnings

    from lz77_tpu.models import codec

    data = bytes(rng.integers(0, 32, 8192, dtype=np.uint8))
    params = spec.Params(la=64, sb=255)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        stream = codec.encode_bytes(
            data, params, block_size=2048, matcher="bitplane"
        )
    assert not any("auto-routing" in str(x.message) for x in w)
    ref = codec.encode_bytes(data, params, block_size=2048, matcher="chunked")
    assert stream == ref
    assert codec.decode_bytes(stream) == data
