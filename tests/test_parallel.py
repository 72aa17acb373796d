"""Mesh/shard_map tests on the virtual 8-device CPU mesh (SURVEY.md §4e)."""

import jax
import numpy as np
import pytest

from lz77_tpu import spec
from lz77_tpu.models import codec
from lz77_tpu.parallel import distributed, mesh as mesh_lib, sharded

from conftest import CORPUS_SMALL, make_text

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)


def test_mesh_shapes():
    m = mesh_lib.make_mesh()
    assert m.shape[mesh_lib.DATA_AXIS] == 8
    m2 = mesh_lib.make_mesh(n_data=4, n_win=2)
    assert m2.shape == {"data": 4, "win": 2}
    with pytest.raises(ValueError):
        mesh_lib.make_mesh(n_data=16, n_win=2)


@pytest.mark.parametrize("n_data,n_win", [(8, 1), (4, 2)])
def test_sharded_match_identical_streams(n_data, n_win, rng):
    """Sharded match phase must emit the exact same stream as single-device."""
    data = make_text(rng, 40_000)
    p = spec.Params(la=15, sb=255)
    m = mesh_lib.make_mesh(n_data=n_data, n_win=n_win)
    mf = sharded.sharded_match_fn(m, p, matcher="brute")
    s_sharded = codec.encode_bytes(
        data, p, block_size=2048, batch_blocks=8, match_fn=mf
    )
    s_single = codec.encode_bytes(data, p, block_size=2048, batch_blocks=8)
    assert s_sharded == s_single
    assert codec.decode_bytes(s_sharded) == data


def test_sharded_match_win_axis_bitplane(rng):
    """The window axis runs the ranged bit-plane sweep (not brute) when the
    matcher is from the bit-plane family — streams stay byte-identical."""
    data = make_text(rng, 40_000)
    p = spec.Params(la=15, sb=255)
    m = mesh_lib.make_mesh(n_data=4, n_win=2)
    mf = sharded.sharded_match_fn(m, p, matcher="bitplane")
    s_sharded = codec.encode_bytes(
        data, p, block_size=2048, batch_blocks=8, match_fn=mf
    )
    s_single = codec.encode_bytes(data, p, block_size=2048, batch_blocks=8)
    assert s_sharded == s_single
    assert codec.decode_bytes(s_sharded) == data


def test_sharded_pipeline_step_valid_stream(rng):
    """Fully fused device pipeline (entry=0) produces a decodable stream."""
    from lz77_tpu import bitio

    data = make_text(rng, 8 * 512)
    p = spec.Params(la=15, sb=255)
    m = mesh_lib.make_mesh(n_data=8, n_win=1)
    step = sharded.make_sharded_pipeline_step(m, p)
    B, G = 512, 8
    x = np.frombuffer(data, np.uint8)
    blocks = x.reshape(G, B)
    H, R = p.d_limit, p.len_limit
    halos = np.zeros((G, H), np.uint8)
    rights = np.zeros((G, R), np.uint8)
    for b in range(1, G):
        halos[b] = x[b * B - H : b * B]
        rights[b - 1] = x[b * B : b * B + R]
    import jax.numpy as jnp

    off, ln, nxt, counts = step(
        jnp.asarray(blocks), jnp.asarray(halos), jnp.asarray(rights),
        jnp.asarray(np.array([0] + [H] * (G - 1), np.int32)),
        jnp.asarray(np.array([B + R] * (G - 1) + [B], np.int32)),
    )
    off, ln, nxt = np.asarray(off), np.asarray(ln), np.asarray(nxt)
    counts = np.asarray(counts)
    chunks = [
        __import__("lz77_tpu.bitio", fromlist=["x"]).tokens_to_bits(
            off[i, : counts[i]], ln[i, : counts[i]], nxt[i, : counts[i]], p
        )
        for i in range(G)
    ]
    stream = bitio.concat_token_bits(chunks, p)
    assert codec.decode_bytes(stream) == data


@pytest.mark.parametrize("n_data,n_win", [(8, 1), (4, 2)])
def test_sharded_exact_step_identical_stream(n_data, n_win, rng):
    """Exact entry-carried sharded step == serial host parse, byte for byte.

    This is the fully fused device pipeline (match + parse + gather all on
    device, entry composed over an all_gather) with NO entry=0
    compromise — the stream must equal codec.encode_bytes exactly, which
    also preserves the size <= reference guarantee.
    """
    data = make_text(rng, 40_000)
    p = spec.Params(la=15, sb=255)
    m = mesh_lib.make_mesh(n_data=n_data, n_win=n_win)
    s = sharded.encode_bytes_sharded(
        data, p, mesh=m, block_size=2048, batch_blocks=8,
        matcher="brute" if n_win > 1 else "sorted",
    )
    ref = codec.encode_bytes(data, p, block_size=2048, batch_blocks=8)
    assert s == ref
    assert codec.decode_bytes(s) == data


def test_sharded_exact_step_ragged_and_empty(rng):
    """Ragged tail (partial final block/batch) and empty input."""
    p = spec.Params(la=15, sb=255)
    m = mesh_lib.make_mesh(n_data=8, n_win=1)
    data = make_text(rng, 33_123)
    s = sharded.encode_bytes_sharded(
        data, p, mesh=m, block_size=2048, batch_blocks=8
    )
    assert s == codec.encode_bytes(data, p, block_size=2048, batch_blocks=8)
    assert sharded.encode_bytes_sharded(b"", p, mesh=m) == codec.encode_bytes(
        b"", p
    )


def test_sharded_exact_step_runs_entry_carry(rng):
    """Runs-heavy data maximizes cross-block token overhang (entry != 0)."""
    data = (b"\x00" * 7000 + make_text(rng, 3000)) * 3
    p = spec.Params(la=15, sb=255)
    m = mesh_lib.make_mesh(n_data=4, n_win=1)
    s = sharded.encode_bytes_sharded(
        data, p, mesh=m, block_size=1024, batch_blocks=8
    )
    assert s == codec.encode_bytes(data, p, block_size=1024, batch_blocks=8)


@pytest.mark.parametrize("n_data,n_win", [(8, 1), (4, 2)])
def test_sharded_walk_identical_stream(n_data, n_win, rng):
    """Byte-aligned width (la=15, sb=15 -> 16-bit tokens): the exact sharded
    step with tokens packed into payload bytes on the device.  The stream
    must equal codec.encode_bytes exactly."""
    data = make_text(rng, 40_000)
    p = spec.Params(la=15, sb=15)
    m = mesh_lib.make_mesh(n_data=n_data, n_win=n_win)
    s = sharded.encode_bytes_sharded(
        data, p, mesh=m, block_size=2048, batch_blocks=8,
        matcher="brute" if n_win > 1 else "sorted",
    )
    ref = codec.encode_bytes(data, p, block_size=2048, batch_blocks=8)
    assert s == ref
    assert codec.decode_bytes(s) == data


def test_sharded_walk_ragged_multibatch(rng):
    """Ragged tail + multiple batches through the byte-aligned path."""
    p = spec.Params(la=15, sb=15)
    m = mesh_lib.make_mesh(n_data=4, n_win=1)
    data = make_text(rng, 33_123)
    s = sharded.encode_bytes_sharded(
        data, p, mesh=m, block_size=1024, batch_blocks=8,
    )
    assert s == codec.encode_bytes(data, p, block_size=1024, batch_blocks=8)
    assert sharded.encode_bytes_sharded(
        b"", p, mesh=m
    ) == codec.encode_bytes(b"", p)


def test_sharded_walk_zeros_bounded_traffic(rng):
    """Zeros-heavy sharded encode: stream identity AND bounded d2h.

    Runs keep every shard boundary mid-token, so each batch's entry comes
    from the composed maps; the host fetches only the bucketed payload
    prefix plus two scalars per batch, never match tables.  This is the
    reference's 0.08 MB/s pathology class (tree.c:87-97)."""
    data = make_text(rng, 5_000) + b"\x00" * 75_000
    p = spec.Params(la=15, sb=15)
    m = mesh_lib.make_mesh(n_data=2, n_win=1)
    st = codec.EncodeStats()
    s = sharded.encode_bytes_sharded(
        data, p, mesh=m, block_size=32768, batch_blocks=2, stats=st,
    )
    assert s == codec.encode_bytes(data, p, block_size=32768, batch_blocks=2)
    assert codec.decode_bytes(s) == data
    # two batches: payload buckets (>= 4 KiB each) + 8 B of scalars; a
    # match-table fetch would add 8 B per input byte.
    assert 0 < st.d2h_bytes < 2 * len(s) + 2 * 4096 + 16, st.d2h_bytes


def test_sharded_walk_default_params(rng):
    """Reference defaults (la=15, sb=4095, 24-bit tokens) through the
    byte-aligned sharded path, entries carried across batches."""
    data = make_text(rng, 60_000)
    p = spec.Params()
    m = mesh_lib.make_mesh(n_data=2, n_win=1)
    s = sharded.encode_bytes_sharded(
        data, p, mesh=m, block_size=8192, batch_blocks=2,
    )
    assert s == codec.encode_bytes(data, p, block_size=8192, batch_blocks=2)


def test_distributed_partitioning():
    assert distributed.block_range(10, 3, 0) == (0, 4)
    assert distributed.block_range(10, 3, 1) == (4, 7)
    assert distributed.block_range(10, 3, 2) == (7, 10)
    counts = np.array([5, 3, 7])
    offs = distributed.global_bit_offsets(counts, 24)
    np.testing.assert_array_equal(offs, [32, 32 + 120, 32 + 192])


def test_distributed_single_process_encode(rng):
    data = CORPUS_SMALL["text"](rng)
    p = spec.Params(la=15, sb=255)
    s = distributed.encode_bytes_multihost(data, p, block_size=1024)
    assert codec.decode_bytes(s) == data


def test_sharded_xla_native_phase_pack_odd_widths(rng):
    """Non-byte-aligned sharded widths: device-compacted token words +
    native phase-aware bit pack (4 B/token host traffic, bitio.c:203-236's
    job done a block at a time).  Odd widths force sub-byte phase carry
    across every batch boundary; streams must equal the serial host parse
    bit for bit."""
    data = make_text(rng, 30_000) + b"\x00" * 5_000
    m = mesh_lib.make_mesh(n_data=4, n_win=1)
    for p in (spec.Params(la=9, sb=511),     # width 21
              spec.Params(la=20, sb=4095)):  # width 25
        s = sharded.encode_bytes_sharded(
            data, p, mesh=m, block_size=2048, batch_blocks=8
        )
        assert s == codec.encode_bytes(data, p, block_size=2048,
                                       batch_blocks=8)
        assert codec.decode_bytes(s) == data
