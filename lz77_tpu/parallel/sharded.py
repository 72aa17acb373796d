"""shard_map block-parallel encode (single-host, multi-device).

Sharded pipelines over a (data, win) mesh (``parallel.mesh``):

* :func:`sharded_match_fn` — shards the batched match phase over the
  ``data`` axis (blocks are independent given their halos) and optionally
  splits each block's distance search over the ``win`` axis, recombining
  partial bests with a max-reduce collective.  Plugs into
  ``models.codec.encode_bytes(match_fn=...)``, so the host-side global parse
  (and the size <= reference guarantee) is unchanged.

* :func:`make_sharded_pipeline_step` — a fully fused device step
  (match + parse + gather on device, per-block entry=0) used by the
  multi-chip dry-run and as the template for future all-device streaming.

* :func:`make_sharded_exact_step` — the fused step WITHOUT the entry=0
  compromise: every shard computes its blocks' entry->exit maps for all
  ``la`` possible parse entries (the same associative map-composition trick
  ``parallel.distributed`` uses across hosts), the (la,)-sized shard maps are
  all-gathered across the data axis, and each shard composes the prefix
  locally to learn its true entry — so the assembled stream is
  byte-identical to the serial host parse (and keeps the size <= reference
  guarantee) while match, parse and token gather all stay on device.
  :func:`iter_batches_sharded` (file path) and :func:`encode_bytes_sharded`
  are the stream-producing wrappers.

The reference has no analog — it is strictly single-threaded (SURVEY.md
§2.2); these are the data- and window-parallel axes of the device build.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import PartitionSpec as P

from .. import spec
from ..ops import match as match_ops
from ..ops import parse as parse_ops
from . import mesh as mesh_lib


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _win_match(matcher: str, la: int, sb: int, n_win: int):
    """(per, fn) for the window-axis distance split.

    ``fn(block, halo, right, avail, valid_ext, d_lo, d_hi)`` sweeps one
    shard's distance sub-range; partial (L, O) results combine with a pmax
    over ``combine_key``.  The bit-plane matcher gets its own ranged sweep
    (~6x lower op count than the brute formulation); its per-shard span is
    rounded up to a multiple of 32 so every shard's first distance is
    1 (mod 32), keeping the static low-5-bit distance-plane trick intact
    (ops/bitplane.py::_sweep).  Every other matcher name runs the ranged
    brute sweep.
    """
    dlim = spec.d_limit(sb)
    per = _cdiv(max(dlim, 1), n_win)
    if matcher == "bitplane":
        from ..ops import bitplane

        per = -(-per // 32) * 32
        fn = functools.partial(
            bitplane.find_matches_bitplane_range, la=la, sb=sb, span=per
        )
    else:
        fn = functools.partial(
            match_ops.find_matches_brute_range, la=la, sb=sb
        )
    return per, fn


def sharded_match_fn(
    mesh, params: spec.Params, *, matcher: str | None = None
):
    """Build a ``match_fn`` for ``codec.encode_bytes`` sharded over ``mesh``.

    The batch of G blocks is split along the ``data`` axis; when the mesh has
    a non-trivial ``win`` axis, each member scans a distance sub-range with
    the brute matcher and partial results are pmax-combined.
    """
    la, sb = params.la, params.sb
    dlim = params.d_limit
    n_win = mesh.shape[mesh_lib.WIN_AXIS]
    matcher = matcher or match_ops.default_matcher(la)

    if n_win == 1:

        def local(blocks, halos, rights, avails, valid_exts):
            find = match_ops.get_matcher(matcher)
            fn = functools.partial(find, la=la, sb=sb)
            return jax.vmap(fn)(blocks, halos, rights, avails, valid_exts)

        specs_in = (
            P(mesh_lib.DATA_AXIS), P(mesh_lib.DATA_AXIS), P(mesh_lib.DATA_AXIS),
            P(mesh_lib.DATA_AXIS), P(mesh_lib.DATA_AXIS),
        )
        specs_out = (P(mesh_lib.DATA_AXIS), P(mesh_lib.DATA_AXIS))
    else:
        per, fn = _win_match(matcher, la, sb, n_win)

        def local(blocks, halos, rights, avails, valid_exts):
            w = lax.axis_index(mesh_lib.WIN_AXIS)
            d_lo = 1 + w * per
            d_hi = jnp.minimum(dlim + 1, d_lo + per)
            L, O = jax.vmap(
                lambda b, h, r, a, v: fn(b, h, r, a, v, d_lo, d_hi)
            )(blocks, halos, rights, avails, valid_exts)
            key = match_ops.combine_key(L, O, dlim)
            key = lax.pmax(key, mesh_lib.WIN_AXIS)
            return match_ops.split_key(key, dlim)

        specs_in = (
            P(mesh_lib.DATA_AXIS), P(mesh_lib.DATA_AXIS), P(mesh_lib.DATA_AXIS),
            P(mesh_lib.DATA_AXIS), P(mesh_lib.DATA_AXIS),
        )
        specs_out = (P(mesh_lib.DATA_AXIS), P(mesh_lib.DATA_AXIS))

    step = jax.jit(
        jax.shard_map(
            local, mesh=mesh, in_specs=specs_in, out_specs=specs_out,
            check_vma=False,
        )
    )

    n_data = mesh.shape[mesh_lib.DATA_AXIS]

    def match_fn(gb, gh, gr, ga, gv):
        G = gb.shape[0]
        if G % n_data:
            raise ValueError(
                f"batch_blocks={G} must be a multiple of data-axis size "
                f"{n_data}"
            )
        return step(
            jnp.asarray(gb), jnp.asarray(gh), jnp.asarray(gr),
            jnp.asarray(ga), jnp.asarray(gv),
        )

    return match_fn


def make_sharded_pipeline_step(
    mesh, params: spec.Params, *, matcher: str = "brute"
):
    """Fully fused device step: blocks -> (off, len, next, counts) sharded.

    Per-block parse with entry=0 (block-aligned token starts): the stream is
    still exactly reference-format-valid; only the size <= reference
    guarantee needs the entry-carried host parse, which the production path
    keeps.  This step exists to exercise the full tp/dp-style sharding in
    one jitted computation (the multi-chip dry-run target).
    """
    la, sb = params.la, params.sb
    dlim = params.d_limit
    n_win = mesh.shape[mesh_lib.WIN_AXIS]
    per, fnr = _win_match(matcher, la, sb, n_win)

    def local(blocks, halos, rights, avails, valid_exts):
        w = lax.axis_index(mesh_lib.WIN_AXIS)
        d_lo = 1 + w * per
        d_hi = jnp.minimum(dlim + 1, d_lo + per)

        def one(block, halo, rightx, avail, valid_ext):
            B = block.shape[0]
            L, O = fnr(block, halo, rightx, avail, valid_ext, d_lo, d_hi)
            key = match_ops.combine_key(L, O, dlim)
            key = lax.pmax(key, mesh_lib.WIN_AXIS)
            L, O = match_ops.split_key(key, dlim)
            # Block-aligned mode: every token must end inside its block
            # (entry is always 0), so clamp lengths at the block boundary.
            pos = jnp.arange(B, dtype=jnp.int32)
            L = jnp.maximum(jnp.minimum(L, B - pos - 1), 0)
            vl = jnp.minimum(valid_ext, B)
            starts, count, _ = parse_ops.greedy_parse(L, vl, 0, la=la)
            block_ext = jnp.concatenate([block, rightx])
            off, ln, nxt = parse_ops.gather_tokens(
                starts, vl, L, O, block_ext, la=la
            )
            return off, ln, nxt, count

        return jax.vmap(one)(blocks, halos, rights, avails, valid_exts)

    d = mesh_lib.DATA_AXIS
    return jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(d), P(d), P(d), P(d), P(d)),
            out_specs=(P(d), P(d), P(d), P(d)),
            check_vma=False,
        )
    )


# ---------------------------------------------------------------------------
# Exact entry-carried sharded step
# ---------------------------------------------------------------------------

def _entry_exit_map(L: jnp.ndarray, valid_len: jnp.ndarray, la: int):
    """(la,) int32 map: parse-exit overhang for every possible entry.

    Squaring the jump table ``p <- min(p + L[p] + 1, end)`` to its fixpoint
    gives f^inf for all positions at once (positions >= valid_len are
    fixpoints, so f^inf == f^B); entry e's exit overhang into the next block
    is ``f^inf(e) - valid_len`` in [0, la).  For a fully padded block
    (valid_len == 0) the map degenerates to the identity, passing entries
    through unchanged.
    """
    B = L.shape[0]
    BE = B + la
    pos = jnp.arange(BE, dtype=jnp.int32)
    Lp = jnp.concatenate([L.astype(jnp.int32), jnp.zeros((la,), jnp.int32)])
    J = jnp.where(
        pos < valid_len, jnp.minimum(pos + Lp + 1, BE - 1), pos
    )
    F = J
    for _ in range(max(1, (BE - 1).bit_length())):
        F = F[F]
    return jnp.clip(F[:la] - valid_len, 0, la - 1)


def _compose_maps(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """(a then b): combined[e] = b[a[e]] along the trailing entry axis."""
    return jnp.take_along_axis(b, a, axis=-1)


def make_sharded_exact_step(
    mesh, params: spec.Params, *, matcher: str | None = None
):
    """Fused sharded device step with the EXACT entry-carried global parse.

    Replaces the reference's serial token loop (lz77.c:89-136) across
    devices: the only cross-block state in the greedy parse is the entry
    offset in [0, la), so each shard derives its blocks' entry->exit maps,
    composes them locally (associative scan), all-gathers the (la,)-sized
    shard totals over the ``data`` axis, and composes the prefix to find its
    own true entry — one tiny collective instead of a serial chain.  Tokens
    are then parsed/gathered per block with the true entries, so the
    assembled stream is byte-identical to the serial host parse.

    Returns ``step(blocks, halos, rights, avails, valid_exts, entry0) ->
    (off, ln, nxt, counts, exit_entry)`` with per-block padded token arrays,
    per-block counts, and the parse entry into the next batch of blocks.
    """
    la, sb = params.la, params.sb
    dlim = params.d_limit
    n_win = mesh.shape[mesh_lib.WIN_AXIS]
    matcher = matcher or match_ops.default_matcher(la)
    per, fnr = _win_match(matcher, la, sb, n_win)

    def local(blocks, halos, rights, avails, valid_exts, entry0):
        Gd, B = blocks.shape

        # ---- match tables (win axis splits the distance search) ----------
        if n_win == 1:
            find = match_ops.get_matcher(matcher)
            fn = functools.partial(find, la=la, sb=sb)
            L, O = jax.vmap(fn)(blocks, halos, rights, avails, valid_exts)
        else:
            w = lax.axis_index(mesh_lib.WIN_AXIS)
            d_lo = 1 + w * per
            d_hi = jnp.minimum(dlim + 1, d_lo + per)
            L, O = jax.vmap(
                lambda b, h, r, a, v: fnr(b, h, r, a, v, d_lo, d_hi)
            )(blocks, halos, rights, avails, valid_exts)
            key = match_ops.combine_key(L, O, dlim)
            key = lax.pmax(key, mesh_lib.WIN_AXIS)
            L, O = match_ops.split_key(key, dlim)
        L = L.astype(jnp.int32)
        O = O.astype(jnp.int32)

        # ---- entry->exit maps, composed within the shard ------------------
        vls = jnp.minimum(valid_exts.astype(jnp.int32), B)  # (Gd,)
        maps = jax.vmap(
            functools.partial(_entry_exit_map, la=la)
        )(L, vls)                                            # (Gd, la)
        P = lax.associative_scan(_compose_maps, maps, axis=0)
        shard_map_total = P[-1]                              # (la,)

        # ---- one collective: compose shard maps across the data axis -----
        gathered = lax.all_gather(
            shard_map_total, mesh_lib.DATA_AXIS
        )                                                    # (n_data, la)
        Pa = lax.associative_scan(_compose_maps, gathered, axis=0)
        e0 = jnp.clip(entry0.astype(jnp.int32), 0, la - 1)
        idx = lax.axis_index(mesh_lib.DATA_AXIS)
        prev = Pa[jnp.maximum(idx - 1, 0), e0]
        entry_shard = jnp.where(idx > 0, prev, e0)
        exit_entry = Pa[-1, e0]

        # ---- per-block true entries within the shard ----------------------
        if Gd > 1:
            entries = jnp.concatenate(
                [entry_shard[None], jnp.take(P[:-1], entry_shard, axis=1)]
            )
        else:
            entries = entry_shard[None]

        # ---- exact parse + token gather ------------------------------------
        def one(Lb, Ob, block, rightx, vl, e):
            starts, count, _ = parse_ops.greedy_parse(Lb, vl, e, la=la)
            block_ext = jnp.concatenate([block, rightx])
            off, ln, nxt = parse_ops.gather_tokens(
                starts, vl, Lb, Ob, block_ext, la=la
            )
            return off, ln, nxt, count

        off, ln, nxt, counts = jax.vmap(one)(
            L, O, blocks, rights, vls, entries
        )
        return off, ln, nxt, counts, exit_entry

    d = mesh_lib.DATA_AXIS
    return jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(d), P(d), P(d), P(d), P(d), P()),
            out_specs=(P(d), P(d), P(d), P(d), P()),
            check_vma=False,
        )
    )


@functools.partial(
    jax.jit, static_argnames=("ob", "lb", "nb"), donate_argnums=(0, 1, 2)
)
def _compact_tokens(off, ln, nxt, counts, *, ob=16, lb=8, nb=0):
    """(G, T) padded token arrays -> one compacted uint32 word per token.

    Token i of the batch (in block-major order) lands at word index
    ``ccum[block] + i_local``; each word fuses off | len<<ob | next<<(ob+lb).
    The default layout (16, 8) holds any token (off <= 65535, len <= 254)
    for the host bit packer.  With ``nb > 0`` the words use the stream's
    own field widths and come back as the low ``nb`` bytes of each word:
    the packed payload of a byte-aligned width, ready to write.  Either way
    one bucketed fetch moves only the batch's real tokens to the host.
    """
    G, T = off.shape
    ccum = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(counts.astype(jnp.int32))]
    )
    t = jnp.arange(G * T, dtype=jnp.int32)
    mi = jnp.clip(
        jnp.searchsorted(ccum, t, side="right").astype(jnp.int32) - 1,
        0, G - 1,
    )
    li = t - ccum[mi]
    src = jnp.clip(mi * T + li, 0, G * T - 1)
    w = (
        off.reshape(-1).astype(jnp.uint32)[src]
        | (ln.reshape(-1).astype(jnp.uint32)[src] << ob)
        | (nxt.reshape(-1).astype(jnp.uint32)[src] << (ob + lb))
    )
    w = jnp.where(t < ccum[-1], w, 0)
    if nb:
        shifts = (jnp.arange(nb, dtype=jnp.uint32) * 8)[None, :]
        w = ((w[:, None] >> shifts) & 0xFF).astype(jnp.uint8).reshape(-1)
    return w, ccum[-1]


def iter_batches_sharded(
    x: np.ndarray,
    params: spec.Params,
    *,
    mesh,
    block_size: int,
    batch_blocks: int,
    matcher: str | None = None,
    **kw,
):
    """Yield (batch_index, e_in, e_out, token_count, payload_bytes) per batch.

    The exact sharded pipeline (:func:`make_sharded_exact_step`) as a
    resumable iterator, the building block for ``encode_bytes_sharded`` and
    the manifest/file path.  Byte-aligned widths only: tokens are compacted
    and packed into payload bytes on the device, and the parse entry is
    carried between batches as a device scalar.  Keyword arguments are those
    of ``models.fused.iter_batches``.
    """
    from jax.sharding import NamedSharding

    from ..models import fused as fused_lib

    if params.width % 8 != 0:
        raise ValueError("sharded iterator requires byte-aligned token width")
    n_data = mesh.shape[mesh_lib.DATA_AXIS]
    if batch_blocks % n_data:
        raise ValueError(
            f"batch_blocks={batch_blocks} must be a multiple of data-axis "
            f"size {n_data}"
        )
    exact = make_sharded_exact_step(mesh, params, matcher=matcher)
    # Stage each batch straight into its data-axis shards, one slice per
    # device, instead of landing it whole on the first device.
    shard = NamedSharding(mesh, P(mesh_lib.DATA_AXIS))
    nb = params.width // 8

    def step(gb, gh, gr, ga, gv, vt, entry_dev):
        off, ln, nxt, counts, exit_entry = exact(
            *(jax.device_put(a, shard) for a in (gb, gh, gr, ga, gv)),
            entry_dev,
        )
        payload, total = _compact_tokens(
            off, ln, nxt, counts,
            ob=params.off_bits, lb=params.len_bits, nb=nb,
        )
        return payload, total, exit_entry

    return fused_lib.iter_batches(
        x, params, step, block_size=block_size, batch_blocks=batch_blocks,
        **kw,
    )


def encode_bytes_sharded(
    data: bytes,
    params: spec.Params | None = None,
    *,
    mesh=None,
    block_size: int | None = None,
    batch_blocks: int | None = None,
    matcher: str | None = None,
    stats=None,
) -> bytes:
    """Compress via the exact sharded pipeline; stream == serial host parse.

    Blocks are sharded over the mesh's ``data`` axis and every width runs
    :func:`make_sharded_exact_step`.  Byte-aligned widths pack tokens into
    payload bytes on the device (:func:`iter_batches_sharded`); other widths
    fetch compacted token words and bit-pack them on the host with a carried
    bit phase.
    """
    from .. import bitio
    from ..models import codec as codec_model

    params = params or spec.Params()
    if mesh is None:
        mesh = mesh_lib.make_mesh()
    n_data = mesh.shape[mesh_lib.DATA_AXIS]
    B = block_size or codec_model.DEFAULT_BLOCK_SIZE
    G = batch_blocks or n_data
    if G % n_data:
        raise ValueError(
            f"batch_blocks={G} must be a multiple of data-axis size {n_data}"
        )
    x = np.frombuffer(data, dtype=np.uint8)
    n = x.shape[0]
    st = stats if stats is not None else codec_model.EncodeStats()
    st.input_bytes = n
    if n == 0:
        st.output_bytes = spec.HEADER_BYTES
        return bitio.header_bytes(params)
    nblocks = _cdiv(n, B)
    num_batches = _cdiv(nblocks, G)

    if params.width % 8 != 0:
        return _encode_bytes_sharded_xla(
            x, n, params, mesh, B, G, nblocks, num_batches, matcher, st
        )

    parts: list[bytes] = [bitio.header_bytes(params)]
    total_tokens = 0
    for _, _, _, tok, payload in iter_batches_sharded(
        x, params, mesh=mesh, block_size=B, batch_blocks=G,
        matcher=matcher, stats=st,
    ):
        total_tokens += tok
        if payload:
            parts.append(payload)

    st.tokens = total_tokens
    st.blocks = nblocks
    stream = b"".join(parts)
    st.output_bytes = len(stream)
    return stream


def _encode_bytes_sharded_xla(
    x, n, params, mesh, B, G, nblocks, num_batches, matcher, st
) -> bytes:
    """Exact sharded step + native phase-aware host pack.

    The non-byte-aligned widths: per-batch tokens are compacted on device
    (4 B/token fetched, not padded (G, B) arrays) and packed by the native
    bit writer with a carried bit phase — the whole-block analog of
    bitio.c:203-236 across devices at any token width.  Streams remain
    byte-identical to the serial host parse.
    """
    from .. import bitio
    from .. import native as native_lib
    from ..models import codec as codec_model

    H, R = params.d_limit, params.len_limit
    step = make_sharded_exact_step(mesh, params, matcher=matcher)
    use_native = native_lib.available()

    out = bytearray(bitio.header_bytes(params))
    bitpos = spec.HEADER_BITS
    chunks: list[np.ndarray] = []  # non-native fallback only
    total_tokens = 0
    entry = jnp.int32(0)
    for bi in range(num_batches):
        g0 = bi * G
        gn = min(G, nblocks - g0)
        gb, gh, gr, ga, gv = codec_model._batch_inputs(x, n, g0, gn, G, B, H, R)
        off, ln, nxt, counts, entry = step(
            jnp.asarray(gb), jnp.asarray(gh), jnp.asarray(gr),
            jnp.asarray(ga), jnp.asarray(gv), entry,
        )
        words_dev, tot_dev = _compact_tokens(off, ln, nxt, counts)
        tot = int(tot_dev)
        total_tokens += tot
        if tot == 0:
            continue
        bk = min(1 << max(12, (tot - 1).bit_length()), words_dev.shape[0])
        words = np.asarray(words_dev[:bk])[:tot]
        off_h = (words & 0xFFFF).astype(np.int32)
        ln_h = ((words >> 16) & 0xFF).astype(np.uint8)
        nxt_h = ((words >> 24) & 0xFF).astype(np.uint8)
        if use_native:
            buf, bits = native_lib.pack_tokens_phase(
                off_h, ln_h, nxt_h, params, bitpos % 8
            )
            if bitpos % 8:
                out[-1] |= buf[0]
                out += buf[1:].tobytes()
            else:
                out += buf.tobytes()
            bitpos += bits
        else:
            chunks.append(bitio.tokens_to_bits(off_h, ln_h, nxt_h, params))
    st.tokens = total_tokens
    st.blocks = nblocks
    if use_native:
        stream = bytes(out)
    else:
        stream = bitio.concat_token_bits(chunks, params)
    st.output_bytes = len(stream)
    return stream
