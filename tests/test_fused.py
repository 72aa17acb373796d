"""Device-resident fused encode pipeline (models/fused.py).

The fused step keeps match -> parse -> gather -> pack on device and must emit
streams byte-identical to the host-parse pipeline (and therefore to the numpy
executable spec and the <= reference-size guarantee chain).
"""

import numpy as np
import pytest

from lz77_tpu import spec
from lz77_tpu.models import codec, fused

from conftest import CORPUS_SMALL, make_text


@pytest.mark.parametrize("name", sorted(CORPUS_SMALL))
def test_fused_matches_host_pipeline(rng, name):
    data = CORPUS_SMALL[name](rng)
    params = spec.Params()
    out = fused.encode_bytes_fused(
        data, params, block_size=2048, batch_blocks=2, matcher="brute",
        sub_block=256,
    )
    ref = codec.encode_bytes(data, params, block_size=2048, matcher="brute")
    assert out == ref
    assert codec.decode_bytes(out) == data


def test_fused_odd_geometry(rng):
    """Block size not a multiple of the sub-block: the batch span's ragged
    tail exercises the valid-boundary rebase of the entry maps."""
    data = make_text(rng, 50000)
    params = spec.Params()
    out = fused.encode_bytes_fused(
        data, params, block_size=10002, batch_blocks=3, matcher="chunked",
        sub_block=512,
    )
    ref = codec.encode_bytes(data, params, block_size=10002, matcher="chunked")
    assert out == ref


def test_fused_entry_carry_across_batches(rng):
    """A long run straddling several batch boundaries forces nonzero entry
    offsets carried device-side between batches."""
    data = b"x" * 9000 + make_text(rng, 3000) + b"y" * 9000
    params = spec.Params()
    out = fused.encode_bytes_fused(
        data, params, block_size=2048, batch_blocks=2, matcher="chunked",
        sub_block=256,
    )
    ref = codec.encode_bytes(data, params, block_size=2048, matcher="chunked")
    assert out == ref


def test_fused_nondefault_aligned_params(rng):
    """la=16, sb=4095 -> 12+4+8 = 24-bit tokens (byte-aligned, non-default)."""
    data = make_text(rng, 20000)
    params = spec.Params(la=16, sb=4095)
    out = fused.encode_bytes_fused(
        data, params, block_size=4096, batch_blocks=2, matcher="chunked",
        sub_block=512,
    )
    ref = codec.encode_bytes(data, params, block_size=4096, matcher="chunked")
    assert out == ref


def test_fused_rejects_unaligned_width():
    params = spec.Params(la=17, sb=4095)  # 12+5+8 = 25 bits
    with pytest.raises(ValueError, match="byte-aligned"):
        fused.encode_bytes_fused(b"abc", params)


def test_fused_cross_decode_oracle(oracle, rng):
    data = make_text(rng, 30000)
    out = fused.encode_bytes_fused(
        data, spec.Params(), block_size=4096, batch_blocks=2,
        matcher="chunked", sub_block=512,
    )
    assert oracle.decode(out) == data
    ref = oracle.encode(data)
    assert len(out) <= len(ref)


def test_fused_stats(rng):
    data = make_text(rng, 20000)
    st = codec.EncodeStats()
    out = fused.encode_bytes_fused(
        data, spec.Params(), block_size=4096, batch_blocks=2,
        matcher="chunked", sub_block=512, stats=st,
    )
    assert st.input_bytes == len(data)
    assert st.output_bytes == len(out)
    assert st.tokens == (len(out) - 4) // 3  # 24-bit tokens
    assert st.blocks == -(-len(data) // 4096)
    assert st.phases.total > 0


def test_fused_deep_la_scan_parser(rng):
    """Deep lookahead (la > 128) stays byte-identical — including the
    widest 32-bit token layout."""
    data = make_text(rng, 100_000) + b"\x00" * 10_000
    for p in (spec.Params(la=255, sb=255), spec.Params(la=129, sb=65535)):
        ref = codec.encode_bytes(data, p, block_size=16384, batch_blocks=4)
        s = fused.encode_bytes_fused(
            data, p, block_size=16384, batch_blocks=4, matcher="chunked"
        )
        assert s == ref
        assert codec.decode_bytes(s) == data


@pytest.fixture(scope="module")
def mixed(rng):
    return (
        make_text(rng, 20_000)
        + b"\x00" * 5_000
        + np.asarray(rng.integers(0, 256, 3_000, dtype=np.uint8)).tobytes()
    )


@pytest.mark.parametrize("la,sb", [(5, 31), (9, 15)])
def test_fused_stream_identity_small_windows(mixed, la, sb):
    """16-bit tokens at tiny windows, 8 KiB blocks, the default matcher."""
    p = spec.Params(la=la, sb=sb)
    s = fused.encode_bytes_fused(mixed, p, block_size=8192, batch_blocks=2)
    assert s == codec.encode_bytes(mixed, p, block_size=8192, batch_blocks=2)
    assert codec.decode_bytes(s) == mixed


def test_fused_ragged_tiny_and_runs(mixed):
    """Ragged tails, tiny inputs and the runs class."""
    p = spec.Params(la=5, sb=31)
    for data in (mixed[:100], mixed[:1], b"", mixed[:9_000],
                 b"\x00" * 24_000):
        s = fused.encode_bytes_fused(data, p, block_size=8192,
                                     batch_blocks=2)
        assert s == codec.encode_bytes(data, p, block_size=8192,
                                       batch_blocks=2), len(data)


def test_fused_entry_carry_one_block_batches(rng):
    """One block per batch: the exit overhang must chain as the next batch's
    entry (runs make every block boundary land mid-token)."""
    p = spec.Params(la=9, sb=15)
    data = b"ab" * 2_000 + b"\x00" * 12_000 + make_text(rng, 12_000)
    s = fused.encode_bytes_fused(data, p, block_size=8192, batch_blocks=1)
    assert s == codec.encode_bytes(data, p, block_size=8192, batch_blocks=1)
