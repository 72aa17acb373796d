"""Bit-plane (bit-sliced) exact match finder.

The distance sweep is the codec's only heavy compute: O(B * d_limit)
candidate comparisons per block (the reference amortises it with a BST walk,
tree.c:118-152; our exact matchers sweep it).  The int-domain sweeps
(`ops.match`) spend one 32-bit lane per *position* on what are 1-bit
quantities (byte equality, run masks).  This matcher packs
32 positions into each int32 lane, cutting the per-(position, distance) op
count ~6x:

* The byte buffer is decomposed into 8 *bit-planes*.  Plane b is a string of
  N bits (bit b of each byte), packed into int32 words with a STRIDED
  layout: bit j of word w holds position ``w + j*NW`` (NW = word count).
  In this layout, shifting a whole plane by one position = rotating the
  word array by one word (the word that wraps moves up one stripe, i.e.
  ``<< 1``) — an O(1)-op whole-plane shift with no sub-word funnels.

* Distances are swept incrementally: 8 shifted source planes (plus a
  shifted source-validity plane) advance by one word per distance.  Byte
  equality at distance d is then ``~OR_b(P_b ^ SP_b) & V_d`` — ~17 word-ops
  covering 32 positions each.

* Run masks by prefix-AND: ``M_k[t] = eq[t] & eq[t+1] & ... & eq[t+k-1]``
  via static one-stripe-safe shifts; ``found_k |= M_k`` accumulates "some
  distance <= d has a match of length >= k at this position".

* Smallest-distance offsets with NO per-position arithmetic: when a
  position's ``found_k`` first flips (``newly_k``), the distance d is
  recorded by OR-ing d's bits into per-k distance bit-planes.  Inside a
  32-iteration unrolled window the low 5 bits of d are STATIC (zero-cost
  plane selection); the high bits are window-constant and folded once per
  window.  First-touch OR == smallest distance — the canonical tie-break,
  so every backend keeps emitting byte-identical streams.

Outputs are bit-exact with ``ops.match.find_matches_brute`` (tested).
Everything is jnp + lax elementwise int32 on whole planes; XLA fuses each
distance window into a handful of elementwise loops.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from .. import spec

_WORD = 32   # positions per int32 word (one per bit)
_DBITS = 16  # max distance bit-planes (d_limit <= 65535)
_WIN = 32    # distances per unrolled window (static low-5-bit trick)


def _to_planes(buf_u8: jnp.ndarray, nw: int) -> jnp.ndarray:
    """(32*nw,) uint8 -> (8, nw) int32 bit-planes in strided layout."""
    b = buf_u8.reshape(_WORD, nw).astype(jnp.int32)  # [j, w] = pos j*nw + w
    js = jnp.arange(_WORD, dtype=jnp.int32)[None, :, None]
    bits = (b[None, :, :] >> jnp.arange(8, dtype=jnp.int32)[:, None, None]) & 1
    return (bits << js).sum(axis=1).astype(jnp.int32)  # (8, nw)


def _pack_mask(cond: jnp.ndarray) -> jnp.ndarray:
    """(32, nw) bool -> (nw,) int32 packed along the stripe axis."""
    js = jnp.arange(_WORD, dtype=jnp.int32)[:, None]
    return (cond.astype(jnp.int32) << js).sum(axis=0)


def _shift_src_k(x: jnp.ndarray, k: int) -> jnp.ndarray:
    """Advance source planes k positions at once (static k < nw).

    y holds the bit at (position - k): a k-word rotate in the strided
    layout, with the k wrapped words moving UP one stripe (``<< 1``).
    Equals k chained single-word shifts (each wrapped word
    re-wraps only after nw further steps, so for k < nw every wrapped word
    moves up exactly one stripe).  The sweep derives each unrolled window
    iteration's planes from the WINDOW-START planes with this, instead of
    chaining 32 single-word shifts: the nested concat-of-slice chain sent
    XLA's algebraic simplifier into its circular-rewrite guard (50 runs,
    "likely stuck" warning) on every CPU compile of the sharded pipelines.
    Independent shifts of one loop-carried value leave nothing to chain.
    """
    if k == 0:
        return x
    return jnp.concatenate([x[..., -k:] << 1, x[..., :-k]], axis=-1)


def _shift_pos_fwd(x: jnp.ndarray, k: int) -> jnp.ndarray:
    """y holds x's bit at (position + k), static k < nw.

    Word rotate the other way; wrapped words move DOWN a stripe (logical
    ``>> 1`` — lax.shift_right_logical so the sign bit does not smear).
    """
    if k == 0:
        return x
    wrapped = lax.shift_right_logical(x[..., :k], jnp.int32(1))
    return jnp.concatenate([x[..., k:], wrapped], axis=-1)


def _shift_src_by(x: jnp.ndarray, k: jnp.ndarray, nw: int) -> jnp.ndarray:
    """Bulk-advance source planes by ``k`` positions (traced k >= 0).

    Strided layout: position t = stripe*nw + word, so shifting by
    ``k = q*nw + r`` = roll words by r (wrapped words move up one stripe,
    ``<< 1``), then move everything up q stripes (``<< q``).  Bits shifted
    past stripe 31 drop — those sources precede the buffer, and the
    validity plane (shifted identically) zeroes them anyway.
    """
    q = k // nw
    r = k % nw
    rolled = jnp.roll(x, r, axis=-1)
    idx = jnp.arange(nw, dtype=jnp.int32)
    rolled = jnp.where(idx[None, :] < r, rolled << 1, rolled)
    return rolled << q


def find_matches_bitplane(
    block: jnp.ndarray,
    halo: jnp.ndarray,
    right: jnp.ndarray,
    avail: jnp.ndarray,
    valid_ext: jnp.ndarray,
    *,
    la: int,
    sb: int,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Same contract as ``ops.match.find_matches_brute`` (bit-plane backend).

    Requires ``halo.shape[0] == d_limit(sb)`` (like the chunked matcher) and
    a block large enough that ``nw > depth`` (run-mask shifts then stay
    within one stripe for any la up to the format's 255 — validated
    bit-exact against the chunked matcher at la = 34 and 64).
    """
    B = block.shape[0]
    depth = spec.len_limit(la)
    dlim = spec.d_limit(sb)
    if dlim == 0 or depth == 0:
        z = jnp.zeros((B,), jnp.int32)
        return z, z
    H = halo.shape[0]
    if H != dlim:
        raise ValueError(
            f"bitplane matcher requires halo size == d_limit ({dlim}), got {H}"
        )
    R = right.shape[0]
    # No hard depth cap: run-mask shifts stay within one stripe whenever
    # nw > depth (checked below), which block sizing guarantees — validated
    # bit-exact against the chunked matcher at la = 34 and 64 (round 3).

    n_real = H + B + R
    nw = -(-n_real // _WORD)
    nw += (-nw) % 128  # lane-friendly word count
    n_tot = _WORD * nw
    if nw <= depth:
        raise ValueError("block too small for bitplane matcher")

    buf = jnp.concatenate(
        [halo, block, right, jnp.zeros((n_tot - n_real,), jnp.uint8)]
    )
    planes = _to_planes(buf, nw)  # (8, nw)

    # Source-validity plane: position t is a usable match SOURCE iff it is a
    # real input byte: t in [H - avail, H + valid_ext).
    pos = (
        jnp.arange(_WORD, dtype=jnp.int32)[:, None] * nw
        + jnp.arange(nw, dtype=jnp.int32)[None, :]
    )
    vplane = _pack_mask((pos >= H - avail) & (pos < H + valid_ext))

    dbits = max(dlim.bit_length(), 6)  # distance bit-planes actually needed
    n_windows = -(-dlim // _WIN)  # window w covers d in [32w+1, 32w+32]
    found, dp = _sweep(
        planes, vplane, d_base=jnp.int32(0), d_hi=jnp.int32(dlim + 1),
        n_windows=n_windows, nw=nw, depth=depth, dlim=dlim, dbits=dbits,
    )
    return _extract(
        found, dp, nw=nw, depth=depth, dbits=dbits, H=H, B=B,
        valid_ext=valid_ext, pos=pos,
    )


def _sweep(
    planes: jnp.ndarray,   # (8, nw) buffer bit-planes
    vplane: jnp.ndarray,   # (nw,) source-validity plane
    *,
    d_base: jnp.ndarray,   # traced: sweep covers d in (d_base, d_base+32*nW]
    d_hi: jnp.ndarray,     # traced exclusive upper bound on d
    n_windows: int,
    nw: int,
    depth: int,
    dlim: int,
    dbits: int,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Incremental distance sweep -> (found (depth,nw), dp (dbits,depth,nw)).

    ``d_base`` MUST be a multiple of 32: window widx sweeps distances
    ``d_base + 32*widx + (1..32)``, so d's low 5 bits stay equal to the
    static unroll index and the zero-cost distance-plane selection trick
    keeps working for a traced base (the window-constant high bits are
    folded with predicated ORs).
    """
    state0 = (
        # sp: source planes pre-advanced to distance d_base (9, nw)
        _shift_src_by(
            jnp.concatenate([planes, vplane[None, :]], axis=0),
            jnp.minimum(d_base, jnp.int32(dlim)), nw,
        ),
        jnp.zeros((depth, nw), jnp.int32),                   # found
        # distance planes as a tuple: plane-b updates touch only (depth, nw)
        tuple(jnp.zeros((depth, nw), jnp.int32) for _ in range(dbits)),
    )

    def window(widx, st):
        sp0, found, dp = st
        dp = list(dp)
        base = d_base + widx * _WIN
        win = jnp.zeros((depth, nw), jnp.int32)
        for i in range(_WIN):
            d = base + i + 1  # traced scalar; low 5 bits = (i+1) & 31 static
            sp = _shift_src_k(sp0, i + 1)
            neq = planes ^ sp[:8]
            acc = neq[0]
            for b in range(1, 8):
                acc = acc | neq[b]
            eq = ~acc & sp[8]
            eq = jnp.where((d <= dlim) & (d < d_hi), eq, 0)
            # Run masks by the uniform recurrence m_k = eq & shift1(m_{k-1})
            # (== AND of k+1 shifted eq planes; composition is exact while
            # cumulative shift < nw, which nw > depth guarantees).  One
            # repeated shift pattern instead of depth distinct slice widths:
            # the varied-width form sent XLA:CPU's algebraic simplifier into
            # a circular-rewrite loop (50+ passes, then a crash) at la >= 64.
            ms = [eq]
            m = eq
            for k in range(1, depth):
                m = eq & _shift_pos_fwd(m, 1)
                ms.append(m)
            newly = jnp.stack(ms) & ~found
            found = found | newly
            if i < _WIN - 1:
                win = win | newly
                for b in range(5):  # static: d's low bits are (i+1)
                    if ((i + 1) >> b) & 1:
                        dp[b] = dp[b] | newly
            else:
                # d = base + 32: low 5 bits are 0; fold its high bits now.
                for b in range(5, dbits):
                    hot = ((base + _WIN) >> b) & 1
                    dp[b] = jnp.where(hot != 0, dp[b] | newly, dp[b])
        # window-constant high bits of d in [base+1, base+31]
        for b in range(5, dbits):
            hot = (base >> b) & 1
            dp[b] = jnp.where(hot != 0, dp[b] | win, dp[b])
        return _shift_src_k(sp0, _WIN), found, tuple(dp)

    _, found, dp = lax.fori_loop(0, n_windows, window, state0)
    return found, jnp.stack(dp)


def find_matches_bitplane_range(
    block: jnp.ndarray,
    halo: jnp.ndarray,
    right: jnp.ndarray,
    avail: jnp.ndarray,
    valid_ext: jnp.ndarray,
    d_lo: jnp.ndarray,
    d_hi: jnp.ndarray,
    *,
    la: int,
    sb: int,
    span: int,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Bit-plane sweep over the distance sub-range [d_lo, d_hi).

    Same contract as ``ops.match.find_matches_brute_range`` (the window-axis
    sharding building block, combined with a pmax over ``combine_key``), at
    the bit-plane matcher's ~6x lower op count.  Constraints: ``d_lo`` must
    be ``1 (mod 32)`` (the sharded caller sizes per-shard spans as multiples
    of 32, so shard w starts at ``1 + w*span``) and ``span`` — the static
    per-shard distance count — a multiple of 32.
    """
    B = block.shape[0]
    depth = spec.len_limit(la)
    dlim = spec.d_limit(sb)
    if dlim == 0 or depth == 0:
        z = jnp.zeros((B,), jnp.int32)
        return z, z
    H = halo.shape[0]
    if H != dlim:
        raise ValueError(
            f"bitplane matcher requires halo size == d_limit ({dlim}), got {H}"
        )
    if span % _WIN:
        raise ValueError(f"span must be a multiple of {_WIN}, got {span}")
    # The static low-5-bit plane-selection trick assumes d_base = d_lo - 1
    # is a multiple of 32; a violating d_lo would silently record wrong
    # distance bit-planes.  Validate when d_lo is concrete (traced values
    # are the sharded caller's, which sizes spans as multiples of 32).
    try:
        d_lo_c = int(d_lo)
    except (TypeError, jax.errors.TracerIntegerConversionError):
        d_lo_c = None
    if d_lo_c is not None and (d_lo_c - 1) % _WIN:
        raise ValueError(
            f"d_lo must be 1 (mod {_WIN}) for the static distance-plane "
            f"selection to hold, got {d_lo_c}"
        )
    R = right.shape[0]

    n_real = H + B + R
    nw = -(-n_real // _WORD)
    nw += (-nw) % 128
    n_tot = _WORD * nw
    if nw <= depth:
        raise ValueError("block too small for bitplane matcher")

    buf = jnp.concatenate(
        [halo, block, right, jnp.zeros((n_tot - n_real,), jnp.uint8)]
    )
    planes = _to_planes(buf, nw)
    pos = (
        jnp.arange(_WORD, dtype=jnp.int32)[:, None] * nw
        + jnp.arange(nw, dtype=jnp.int32)[None, :]
    )
    vplane = _pack_mask((pos >= H - avail) & (pos < H + valid_ext))

    dbits = max(dlim.bit_length(), 6)
    found, dp = _sweep(
        planes, vplane,
        d_base=jnp.asarray(d_lo - 1, jnp.int32),
        d_hi=jnp.minimum(jnp.asarray(d_hi, jnp.int32), dlim + 1),
        n_windows=span // _WIN, nw=nw, depth=depth, dlim=dlim, dbits=dbits,
    )
    return _extract(
        found, dp, nw=nw, depth=depth, dbits=dbits, H=H, B=B,
        valid_ext=valid_ext, pos=pos,
    )


def _extract(
    found: jnp.ndarray,   # (depth, nw)
    dp: jnp.ndarray,      # (dbits, depth, nw)
    *,
    nw: int,
    depth: int,
    dbits: int,
    H: int,
    B: int,
    valid_ext: jnp.ndarray,
    pos: jnp.ndarray,     # (32, nw) strided position index
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Unpack found masks + distance bit-planes into per-position (L, O).

    L = count of set found_k (monotone in k), capped by lookahead
    shrinkage; O = the distance value recorded at k = L.
    """
    js = jnp.arange(_WORD, dtype=jnp.int32)[None, :, None]
    fbits = (found[:, None, :] >> js) & 1  # (depth, 32, nw)
    l_raw = fbits.sum(axis=0)  # (32, nw)
    cap = jnp.minimum(depth, valid_ext - (pos - H) - 1)
    l_full = jnp.minimum(l_raw, jnp.maximum(cap, 0))

    dvals = jnp.zeros((depth, _WORD, nw), jnp.int32)
    for b in range(dbits):
        dvals = dvals + (((dp[b][:, None, :] >> js) & 1) << b)
    ksel = jnp.maximum(l_full - 1, 0)[None]  # (1, 32, nw)
    o_full = jnp.take_along_axis(dvals, ksel, axis=0)[0]
    o_full = jnp.where(l_full > 0, o_full, 0)

    L = l_full.reshape(-1)[H : H + B]
    O = o_full.reshape(-1)[H : H + B]
    return L, O
