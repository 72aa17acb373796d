"""Every XLA matcher against the brute distance sweep.

The geometries are those the round-trip suite cannot reach cheaply: full
halos, lookahead shrinkage at a ragged block end, and window/lookahead pairs
from the default down to tiny ones.  All matchers are exact, so L and O must
equal the brute sweep's position by position (smallest-offset tie-break
included).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lz77_tpu import spec
from lz77_tpu.ops import match as match_ops

from conftest import make_text

FAST = ("bitplane", "chunked", "sorted")


def _agree(args, la, sb):
    L0, O0 = jax.jit(functools.partial(
        match_ops.find_matches_brute, la=la, sb=sb))(*args)
    for name in FAST:
        L1, O1 = jax.jit(functools.partial(
            match_ops.get_matcher(name), la=la, sb=sb))(*args)
        np.testing.assert_array_equal(np.asarray(L1), np.asarray(L0), name)
        np.testing.assert_array_equal(np.asarray(O1), np.asarray(O0), name)


@pytest.mark.parametrize("la,sb", [(15, 4095), (8, 500), (4, 129)])
def test_matchers_match_brute(la, sb, rng):
    p = spec.Params(la=la, sb=sb)
    B = 2048
    x = np.frombuffer(make_text(rng, B), np.uint8)
    args = (
        jnp.asarray(x), jnp.zeros(p.d_limit, jnp.uint8),
        jnp.zeros(p.len_limit, jnp.uint8), jnp.int32(0), jnp.int32(B),
    )
    _agree(args, la, sb)


def test_matchers_with_halo_and_shrinkage(rng):
    p = spec.Params()
    B = 1024
    data = np.frombuffer(make_text(rng, B + p.d_limit), np.uint8)
    halo, x = data[: p.d_limit], data[p.d_limit :]
    valid = B - 100  # partial final block: lookahead shrinkage at the end
    xb = x.copy()
    xb[valid:] = 0
    args = (
        jnp.asarray(xb), jnp.asarray(halo), jnp.zeros(p.len_limit, jnp.uint8),
        jnp.int32(p.d_limit), jnp.int32(valid),
    )
    _agree(args, 15, 4095)


def test_matchers_reject_bad_geometry():
    """Halo-shaped matchers refuse a halo that is not d_limit bytes, and
    names outside the registry are refused."""
    p = spec.Params()
    for name in ("bitplane", "chunked"):
        with pytest.raises(ValueError, match="halo"):
            match_ops.get_matcher(name)(
                jnp.zeros(1024, jnp.uint8), jnp.zeros(10, jnp.uint8),
                jnp.zeros(p.len_limit, jnp.uint8), jnp.int32(0),
                jnp.int32(1024), la=15, sb=4095,
            )
    for name in ("pallas", "pallas_bitplane", "walk"):
        with pytest.raises(ValueError, match="unknown matcher"):
            match_ops.get_matcher(name)
    for la in (2, 15, 16, 17, 255):
        assert match_ops.default_matcher(la) in match_ops.MATCHERS
