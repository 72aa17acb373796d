"""Device-resident fused encode: match -> parse -> gather -> pack in one jit.

Replaces the reference's serial token loop (lz77.c:89-136) AND its bit writer
(lz77.c:246-251, bitio.c:203-236) with a single device computation per batch;
the host only uploads raw bytes and fetches packed payload bytes + per-block
token counts.  The host-parse pipeline in ``models.codec`` serves the
non-byte-aligned token widths.

The greedy parse's jump chain ``p <- p + L[p] + 1`` is the only sequential
dependency.  It is resolved hierarchically, entirely with batched 2-D gathers
(no serial walk, no long 1-D scatter):

  1. The batch of G consecutive blocks is one contiguous span of the file
     (G*B bytes).  Split it into M sub-blocks of ``s`` bytes.
  2. A token can overhang a sub-block boundary by at most la-1 bytes, so a
     sub-block's parse state is just its *entry offset* e in [0, la).  Each
     sub-block's jump table (s+la wide) is squared log2(s) times to produce
     its full entry->exit map — all M sub-blocks at once, f^(2^k) via
     ``take_along_axis`` along the last axis.
  3. Maps compose associatively: ``jax.lax.associative_scan`` over the M maps
     yields every sub-block's true entry in log2(M) steps (the same
     entry-map trick ``parallel.distributed`` uses across hosts).
  4. With entries known, per-sub-block token starts come from a batched
     pointer-doubling orbit (greedy_parse's fill, batched over M).
  5. Tokens are compacted at token granularity (cumsum of counts +
     searchsorted) and packed to bytes by affine shifts (token width is
     constant per stream — SURVEY.md §2.3.2).  The payload buffer stays on
     device; the host fetches only the true payload prefix.

Streams are byte-identical to the host-parse pipeline and the numpy
executable spec (asserted in tests/test_fused.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .. import spec
from ..ops import match as match_ops

DEFAULT_SUB_BLOCK = 1 << 10


def _log2_ceil(n: int) -> int:
    return max(1, (n - 1).bit_length())


@functools.partial(
    jax.jit,
    static_argnames=("la", "sb", "matcher", "sub_block", "with_map", "head_w"),
)
def encode_batch_device(
    blocks: jnp.ndarray,      # (G, B) uint8
    halos: jnp.ndarray,       # (G, H) uint8
    rights: jnp.ndarray,      # (G, R) uint8
    avails: jnp.ndarray,      # (G,) int32
    valid_exts: jnp.ndarray,  # (G,) int32
    valid_total: jnp.ndarray,  # scalar int32: valid bytes in the batch span
    entry0: jnp.ndarray,      # scalar int32: parse entry into this batch
    *,
    la: int,
    sb: int,
    matcher: str | None = None,
    sub_block: int = DEFAULT_SUB_BLOCK,
    with_map: bool = False,
    head_w: int = 8192,
):
    """One fused device step over a batch of consecutive blocks.

    Returns (payload, counts, total_tokens, exit_entry):
      payload: (M*s*nb,) uint8 — packed token bytes, valid prefix only;
      counts: (G,) int32 — tokens per block (for stats/manifest);
      total_tokens: scalar int32;
      exit_entry: scalar int32 — parse entry into the next batch.
    Requires a byte-aligned token width (width % 8 == 0).

    ``with_map=True`` additionally returns (bmap, l_head, o_head): the
    batch's full (la,) entry->exit-overhang map (free — the internal
    sub-block map composition already produces it) and the first ``head_w``
    positions' match tables.  This is the building block for speculative
    cross-host encoding (parallel/distributed.py): a host parses its range
    from entry 0 while the exact exit for ANY entry rides in the composed
    maps, and a nonzero true entry needs only a head-window resync splice.
    """
    params = spec.Params(la=la, sb=sb)
    if params.width % 8 != 0:
        raise ValueError("fused pipeline requires byte-aligned token width")
    nb = params.width // 8
    G, B = blocks.shape
    s = sub_block
    N = G * B
    M = -(-N // s)
    NP = M * s  # padded span length

    # ---- 1. match tables (the hot phase), flattened to the batch span ----
    # named scopes label the device trace by stage (match / parse / pack)
    with jax.named_scope("match"):
        find = match_ops.get_matcher(matcher, la)
        fn = functools.partial(find, la=la, sb=sb)
        L, O = jax.vmap(fn)(blocks, halos, rights, avails, valid_exts)
    L_flat = L.reshape(N).astype(jnp.int32)
    O_flat = O.reshape(N).astype(jnp.int32)

    with jax.named_scope("parse"):
        # ---- 2. per-sub-block jump tables and entry->exit maps ------------
        # J[m, p]: local chain position p in [0, s+la) of sub-block m.  Token
        # starts are positions with global index < valid_total; everything else
        # is a fixpoint (greedy_parse semantics, ops/parse.py).
        L_pad = jnp.concatenate(
            [L_flat, jnp.zeros((NP - N + la,), jnp.int32)]
        )
        pos_l = jnp.arange(s + la, dtype=jnp.int32)[None, :]       # (1, s+la)
        base = (jnp.arange(M, dtype=jnp.int32) * s)[:, None]        # (M, 1)
        gpos = base + pos_l                                         # (M, s+la)
        Lg = L_pad[gpos]
        live = (pos_l < s) & (gpos < valid_total)
        J = jnp.where(
            live, jnp.minimum(pos_l + Lg + 1, s + la - 1), pos_l
        )  # (M, s+la)

        # f^s by squaring: log2(s) take_along_axis gathers over (M, s+la).
        F = J
        for _ in range(_log2_ceil(s)):
            F = jnp.take_along_axis(F, F, axis=1)
        # next-entry map, rebased against the sub-block's VALID span: chains
        # stop at the first position >= the valid boundary, so the overhang is
        # exit - vl_local.  For full sub-blocks vl_local == s (boundary s); for
        # the batch's ragged tail (N % s != 0) it is the true end-of-batch
        # boundary; for fully-padded sub-blocks (vl_local == 0) the map becomes
        # the identity, passing the entry through the pad region unchanged.
        vl_local = jnp.clip(valid_total - base, 0, s)  # (M, 1)
        nmap = jnp.clip(F[:, :la] - vl_local, 0, la - 1)  # (M, la)

        # ---- 3. compose maps across sub-blocks (associative scan) --------
        def compose(a, b):  # (a then b): combined[e] = b[a[e]]
            return jnp.take_along_axis(b, a, axis=-1)

        P = lax.associative_scan(compose, nmap, axis=0)  # inclusive prefixes
        e0 = jnp.clip(entry0.astype(jnp.int32), 0, la - 1)
        entries = jnp.concatenate(
            [e0[None],
             P[:-1, :][:, e0] if M > 1 else jnp.zeros((0,), jnp.int32)]
        )  # (M,) true entry of each sub-block
        exit_entry = P[-1, e0]

        # ---- 4. token starts: batched pointer-doubling orbit -------------
        # S[m, i] = f^i(entry_m); chain values never exceed s+la-1.
        S = jnp.zeros((M, s), jnp.int32).at[:, 0].set(entries)
        Jp = J
        m_fill = 1
        while m_fill < s:
            span = min(m_fill, s - m_fill)
            tail = jnp.take_along_axis(Jp, S[:, :span], axis=1)
            S = lax.dynamic_update_slice(S, tail, (0, m_fill))
            Jp = jnp.take_along_axis(Jp, Jp, axis=1)
            m_fill *= 2

        tok_valid = S < vl_local                       # (M, s)
        counts_m = tok_valid.astype(jnp.int32).sum(axis=1)  # (M,)

    with jax.named_scope("pack"):
        # ---- 5. compact + pack --------------------------------------------
        ccum = jnp.concatenate(
            [jnp.zeros((1,), jnp.int32), jnp.cumsum(counts_m)]
        )  # (M+1,)
        total_tokens = ccum[-1]
        Tcap = NP
        t = jnp.arange(Tcap, dtype=jnp.int32)
        mi = jnp.searchsorted(ccum, t, side="right").astype(jnp.int32) - 1
        mi = jnp.clip(mi, 0, M - 1)
        li = t - ccum[mi]
        # (M, s) gathered at (mi, li): flatten for a single 1-D gather.
        start_l = S.reshape(-1)[mi * s + li]
        gstart = mi * s + start_l
        gstart = jnp.minimum(gstart, N - 1)
        ln = L_flat[gstart]
        off = O_flat[gstart]
        x_ext = jnp.concatenate([blocks.reshape(N), rights[G - 1]])
        nxt = x_ext[jnp.minimum(gstart + ln, N + rights.shape[1] - 1)]
        tvalid = t < total_tokens
        v = (
            off.astype(jnp.uint32)
            | (ln.astype(jnp.uint32) << params.off_bits)
            | (nxt.astype(jnp.uint32) << (params.off_bits + params.len_bits))
        )
        v = jnp.where(tvalid, v, 0)
        shifts = (jnp.arange(nb, dtype=jnp.uint32) * 8)[None, :]
        payload = (
            (v[:, None] >> shifts) & jnp.uint32(0xFF)
        ).astype(jnp.uint8).reshape(Tcap * nb)

    # per-block counts for stats/manifest (S_per = sub-blocks per block)
    if (B % s) == 0:
        counts_b = counts_m.reshape(G, B // s).sum(axis=1)
    else:
        blk = (base[:, 0] // B).astype(jnp.int32)  # block of each sub-block
        counts_b = jnp.zeros((G,), jnp.int32).at[blk].add(counts_m)

    if with_map:
        w = min(head_w, N)
        return (
            payload, counts_b, total_tokens, exit_entry,
            P[-1],                      # (la,) batch entry->exit map
            L_flat[:w], O_flat[:w],     # head match tables for resync
        )
    return payload, counts_b, total_tokens, exit_entry


def _bucket(nbytes: int) -> int:
    """Fetch-size bucket (few distinct compiled device slices).

    Power-of-two below 1 MiB, then 1 MiB steps: a pure power-of-two bucket
    overfetches up to 2x on multi-MB payloads, which is real host<->device
    traffic at file scale (a ~4.2 MB batch payload used to fetch 8 MB);
    1 MiB quantization caps the overfetch at <1 MiB while keeping the
    number of distinct compiled slice shapes small.
    """
    if nbytes <= 0:
        return 0
    if nbytes <= (1 << 20):
        return 1 << max(12, (nbytes - 1).bit_length())
    return -(-nbytes // (1 << 20)) * (1 << 20)


def _resolve_block_size(params: spec.Params, block_size: int | None) -> int:
    """Validate the token width; default the block size."""
    from . import codec as codec_model  # lazy: avoid import cycle

    if params.width % 8 != 0:
        raise ValueError("fused pipeline requires byte-aligned token width")
    return block_size or codec_model.DEFAULT_BLOCK_SIZE


def iter_batches_fused(
    x: np.ndarray,
    params: spec.Params,
    *,
    block_size: int | None = None,
    batch_blocks: int = 8,
    matcher: str | None = None,
    sub_block: int = DEFAULT_SUB_BLOCK,
    **kw,
):
    """Yield (batch_index, e_in, e_out, token_count, payload_bytes) per batch.

    The fused device pipeline as a resumable iterator — the building block
    for both ``encode_bytes_fused`` and the manifest/file path (the device
    replaces lz77.c:89-136 + 246-251 at file scale, not just bytes scale).
    Keyword arguments are those of :func:`iter_batches`.
    """
    block_size = _resolve_block_size(params, block_size)

    def step(gb, gh, gr, ga, gv, vt, entry_dev):
        payload, _, total, exit_entry = encode_batch_device(
            jnp.asarray(gb), jnp.asarray(gh), jnp.asarray(gr),
            jnp.asarray(ga), jnp.asarray(gv), vt, entry_dev,
            la=params.la, sb=params.sb, matcher=matcher, sub_block=sub_block,
        )
        return payload, total, exit_entry

    return iter_batches(
        x, params, step, block_size=block_size, batch_blocks=batch_blocks,
        **kw,
    )


def iter_batches(
    x: np.ndarray,
    params: spec.Params,
    step,
    *,
    block_size: int,
    batch_blocks: int,
    start_batch: int = 0,
    entry: int = 0,
    phases=None,
    stats=None,
    retries: int = 2,
):
    """Drive a device encode ``step`` over the batches of ``x``.

    ``step(blocks, halos, rights, avails, valid_exts, valid_total, entry)``
    takes one batch as host arrays plus two device scalars and returns
    (payload, total_tokens, exit_entry) on the device, where payload holds
    the batch's packed token bytes (byte-aligned widths).  Yields
    (batch_index, e_in, e_out, token_count, payload_bytes) per batch.
    ``start_batch``/``entry`` resume mid-stream.  Two-deep software
    pipeline: the device chews batch k+1 (entry carried as a device scalar —
    no host roundtrip on the dependency chain) while the host fetches batch
    k's payload prefix.
    """
    from . import codec as codec_model
    from ..utils import metrics as metrics_lib

    n = x.shape[0]
    nb_bytes = params.width // 8
    B, G = block_size, batch_blocks
    H, R = params.d_limit, params.len_limit
    nblocks = -(-n // B)
    num_batches = -(-nblocks // G)
    if phases is None and stats is not None:
        phases = stats.phases
    ph = phases if phases is not None else metrics_lib.PhaseTimes()

    def submit(bi: int, entry_dev):
        g0 = bi * G
        gn = min(G, nblocks - g0)
        arrays = codec_model._batch_inputs(x, n, g0, gn, G, B, H, R)
        vt = min(G * B, n - g0 * B)
        if stats is not None:
            stats.h2d_bytes += sum(a.nbytes for a in arrays)
        payload, total, exit_entry = step(*arrays, jnp.int32(vt), entry_dev)
        return bi, payload, total, exit_entry

    def fetch(handle, e_in: int):
        bi, payload, total, exit_entry = handle
        with metrics_lib.StopwatchPhase(ph, "match"):
            tot, ex = (int(v) for v in jax.device_get((total, exit_entry)))
            nbytes = tot * nb_bytes
            if nbytes:
                bk = min(_bucket(nbytes), payload.shape[0])
                buf = np.asarray(payload[:bk])[:nbytes].tobytes()
            else:
                bk = 0
                buf = b""
            if stats is not None:
                stats.d2h_bytes += bk + 8
        return bi, e_in, ex, tot, buf

    from ..utils import faults as faults_lib

    def count_retry():
        if stats is not None:
            stats.retries += 1

    entry_dev = jnp.int32(entry)
    e_in = int(entry)
    pending = None
    for bi in range(start_batch, num_batches):
        with metrics_lib.StopwatchPhase(ph, "io"):
            # Failed device batches retry (SURVEY.md §5): batches are
            # independent up to the entry scalar, which submit re-derives
            # from the still-live previous device value.
            nxt = faults_lib.with_retries(
                submit, bi, entry_dev, retries=retries, on_retry=count_retry
            )
            entry_dev = nxt[3]
        if pending is not None:
            out = faults_lib.with_retries(
                fetch, pending, e_in, retries=retries, on_retry=count_retry
            )
            e_in = out[2]
            yield out
        pending = nxt
    if pending is not None:
        yield faults_lib.with_retries(
            fetch, pending, e_in, retries=retries, on_retry=count_retry
        )


def encode_bytes_fused(
    data: bytes,
    params: spec.Params | None = None,
    *,
    block_size: int | None = None,
    batch_blocks: int = 8,
    matcher: str | None = None,
    sub_block: int = DEFAULT_SUB_BLOCK,
    stats=None,
) -> bytes:
    """Compress via the fused device pipeline (byte-aligned widths only)."""
    from . import codec as codec_model  # lazy: avoid import cycle
    from .. import bitio
    from ..utils import metrics as metrics_lib

    params = params or spec.Params()
    block_size = _resolve_block_size(params, block_size)
    x = np.frombuffer(data, dtype=np.uint8)
    n = x.shape[0]
    st = stats if stats is not None else codec_model.EncodeStats()
    st.input_bytes = n

    if n == 0:
        st.output_bytes = spec.HEADER_BYTES
        return bitio.header_bytes(params)

    parts: list[bytes] = [bitio.header_bytes(params)]
    total_tokens = 0
    with metrics_lib.StopwatchPhase(st.phases, "total"):
        for _, _, _, tok, payload in iter_batches_fused(
            x, params, block_size=block_size, batch_blocks=batch_blocks,
            matcher=matcher, sub_block=sub_block, stats=st,
        ):
            total_tokens += tok
            if payload:
                parts.append(payload)
        st.tokens = total_tokens
        st.blocks = -(-n // block_size)
        stream = b"".join(parts)
        st.output_bytes = len(stream)
    return stream
