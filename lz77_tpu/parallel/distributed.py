"""Multi-host orchestration (SURVEY.md §7 phase 3).

The reference is a single process with stdio as its only transport
(SURVEY.md §2.2); the device build's multi-host story:

* ``jax.distributed.initialize`` for process-group setup (DCN/Gloo);
* contiguous block-range partitioning per host — blocks need only raw input
  bytes (halo + right extension), so hosts share nothing during the match
  phase;
* the greedy parse's serial entry-offset chain is resolved WITHOUT
  serializing hosts: a token can overhang a block boundary by at most la-1
  bytes, so each host computes its range's entry -> exit map for all la
  possible entries (la cheap native walks over already-computed match
  lengths), one tiny allgather shares the maps, and every host composes the
  prefix to learn its true entry — then emits its final tokens;
* per-block token counts are allgathered so global bit offsets are affine
  (``32 + width * cumsum(counts)``);
* payload collection is ORDERED and sized per host: the production path
  (:func:`encode_file_multihost`) has every host ``pwrite`` its own segment
  of the shared output file at its computed byte offset — zero inter-host
  payload traffic; the in-memory path (:func:`encode_bytes_multihost`)
  broadcasts each host's exact-size payload in rank order (no padding to
  the global max, unlike the round-1 allgather).

Runs degenerate-correctly in a single process, and is exercised for real by
``tests/test_multihost.py`` via 2- and 4-process CPU runs over Gloo (§4e).
"""

from __future__ import annotations

import numpy as np

import jax

from .. import bitio, spec
from ..models import codec as codec_model
from ..models import encoder as encoder_model


def initialize(coordinator_address=None, num_processes=None, process_id=None):
    """Initialize jax.distributed when running multi-process; no-op solo."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def block_range(num_blocks: int, num_processes: int, process_id: int):
    """Contiguous near-even split of blocks over hosts."""
    base, extra = divmod(num_blocks, num_processes)
    lo = process_id * base + min(process_id, extra)
    hi = lo + base + (1 if process_id < extra else 0)
    return lo, hi


def global_bit_offsets(counts: np.ndarray, width: int) -> np.ndarray:
    """Bit offset of each block's payload in the final stream (affine)."""
    return spec.HEADER_BITS + width * np.concatenate(
        [[0], np.cumsum(counts.astype(np.int64))[:-1]]
    )


def _parse_range(
    Ls: list[np.ndarray], vls: list[int], entry: int, la: int
) -> tuple[list[np.ndarray], int]:
    """Chain the per-block parse across a host's range from ``entry``."""
    from .. import native as native_lib

    use_native = native_lib.available()
    all_starts = []
    for L, vl in zip(Ls, vls):
        if use_native:
            starts, exit_pos = native_lib.parse_block(L, vl, entry)
        else:
            starts, exit_pos = codec_model.parse_block_np(L, vl, entry, la)
        all_starts.append(starts)
        entry = max(0, exit_pos - L.shape[0])
    return all_starts, entry


def _encode_range(
    x: np.ndarray,
    n: int,
    params: spec.Params,
    *,
    block_size: int,
    batch_blocks: int,
    matcher: str,
    retries: int = 2,
    fault_injector=None,
    work_seconds: list | None = None,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Phases 1-3 for this process's block range.

    Returns (counts over ALL blocks with my range filled in, my payload bit
    array or bytes, my payload bit length).  ``work_seconds`` (if a list)
    receives a {"wall", "cpu"} dict for the pure-compute region, excluding
    collectives — used by the scaling-efficiency measurement (cpu time is
    immune to core oversubscription; Gloo collectives busy-poll, so they
    must stay outside the measured region).
    """
    import time

    from jax.experimental import multihost_utils

    from ..utils import faults as faults_lib

    nproc = jax.process_count()
    pid = jax.process_index()
    la = params.la
    B = block_size
    nb = -(-n // B) if n else 0
    lo, hi = block_range(nb, nproc, pid)

    t_work0 = time.perf_counter()
    c_work0 = time.process_time()
    # Phase 1: match tables for my range (device), fetched to host.  A
    # failed device batch is retried — blocks are independent (SURVEY.md §5).
    Ls: list[np.ndarray] = []
    Os: list[np.ndarray] = []
    vls: list[int] = []
    H, R = params.d_limit, params.len_limit
    G = batch_blocks
    for g0 in range(lo, hi, G):
        gn = min(G, hi - g0)

        def run_batch(g0=g0, gn=gn):
            if fault_injector is not None:
                fault_injector.check(g0)
            gb, gh, gr, ga, gv = codec_model._batch_inputs(
                x, n, g0, gn, G, B, H, R
            )
            import jax.numpy as jnp

            L, O = encoder_model.match_blocks(
                jnp.asarray(gb), jnp.asarray(gh), jnp.asarray(gr),
                jnp.asarray(ga), jnp.asarray(gv),
                la=params.la, sb=params.sb, matcher=matcher,
            )
            return np.asarray(L), np.asarray(O)

        Ln, On = faults_lib.with_retries(run_batch, retries=retries)
        for i in range(gn):
            Ls.append(Ln[i].astype(np.uint8))
            Os.append(On[i].astype(np.uint16))
            vls.append(min(B, n - (g0 + i) * B))

    # Phase 2: entry->exit map for my range, one walk per possible entry.
    exits = np.zeros(la, np.int32)
    for e in range(la):
        _, ex = _parse_range(Ls, vls, e, la)
        exits[e] = ex
    t_work = time.perf_counter() - t_work0
    c_work = time.process_time() - c_work0
    all_exits = np.asarray(multihost_utils.process_allgather(exits))

    # Compose prefix maps: my true entry.
    entry = 0
    for h in range(pid):
        entry = int(all_exits[h][entry])

    # Phase 3: final parse + token emission for my range.
    t_work0 = time.perf_counter()
    c_work0 = time.process_time()
    starts_list, _ = _parse_range(Ls, vls, entry, la)
    counts = np.zeros(nb, np.int64)
    chunks: list[np.ndarray] = []
    for k, starts in enumerate(starts_list):
        b = lo + k
        counts[b] = starts.shape[0]
        if starts.shape[0] == 0:
            continue
        gs = b * B
        ln = Ls[k][starts].astype(np.int64)
        off = Os[k][starts].astype(np.int64)
        nx = x[gs + starts + ln]
        chunks.append(bitio.tokens_to_chunk(off, ln, nx, params))
    if bitio.byte_aligned(params):
        payload = np.concatenate(chunks) if chunks else np.zeros(0, np.uint8)
        nbits = int(payload.shape[0]) * 8
    else:
        payload = np.concatenate(chunks) if chunks else np.zeros(0, np.uint8)
        nbits = int(payload.shape[0])
    if work_seconds is not None:
        work_seconds.append({
            "wall": t_work + (time.perf_counter() - t_work0),
            "cpu": c_work + (time.process_time() - c_work0),
        })
    return counts, payload, nbits


RESYNC_WINDOW = 8192  # head match-table span for the cross-host splice


def _range_encoder(params: spec.Params, pipeline: str):
    """Select the per-host range encoder.

    'auto' = the fused device pipeline for byte-aligned token widths
    (device-packed payload, ~6x less device-to-host traffic), else the
    host-parse pipeline; 'host'/'fused' force a choice.
    """
    if pipeline == "auto":
        pipeline = "fused" if bitio.byte_aligned(params) else "host"
    if pipeline == "fused":
        if not bitio.byte_aligned(params):
            raise ValueError(
                "multihost pipeline='fused' requires a byte-aligned token "
                f"width (width={params.width}); use pipeline='host'"
            )
        return _encode_range_fused
    if pipeline != "host":
        raise ValueError(f"unknown multihost pipeline {pipeline!r}")
    return _encode_range


def _encode_range_fused(
    x: np.ndarray,
    n: int,
    params: spec.Params,
    *,
    block_size: int,
    batch_blocks: int,
    matcher: str,
    retries: int = 2,
    fault_injector=None,
    work_seconds: list | None = None,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Fused-device phases for this process's block range (byte-aligned).

    Same contract as :func:`_encode_range`, through the device-resident
    match+parse+pack step instead of full (L, O) fetch + host parse:

    * the host's range parses SPECULATIVELY from entry 0 on device (entry
      carried between batches as a device scalar), fetching ~0.5 B packed
      payload per input byte instead of ~3 B of match tables;
    * the EXACT (la,)-entry->exit map of the whole range falls out of the
      scan parser's internal sub-block map composition for free, so one
      allgather of the (la,) maps gives every host its true entry with no
      merge assumption (the same composition :func:`_encode_range` computes
      with la serial re-parses);
    * a nonzero true entry is fixed by a head-window resync splice (greedy
      chains from different entries merge at the first shared token start —
      the native MT encoder's property, lz77host.cpp:269-528); the rare
      never-resync case re-runs the range with the true entry, exactly.
    """
    import time

    import jax.numpy as jnp
    from jax.experimental import multihost_utils

    from .. import native as native_lib
    from ..models import fused as fused_lib
    from ..utils import faults as faults_lib

    nproc = jax.process_count()
    pid = jax.process_index()
    la = params.la
    nb_bytes = params.width // 8
    ob, lb = params.off_bits, params.len_bits
    B = block_size
    nb = -(-n // B) if n else 0
    lo, hi = block_range(nb, nproc, pid)
    G = batch_blocks
    H, R = params.d_limit, params.len_limit
    span_end = min(hi * B, n)
    my_span = max(0, span_end - lo * B)

    def run_range(entry0: int):
        """Speculative (or exact, once entry is known) fused range encode."""
        counts = np.zeros(nb, np.int64)
        parts: list[bytes] = []
        cum_map = np.arange(la, dtype=np.int64)
        head = {}
        entry_dev = jnp.int32(entry0)
        for g0 in range(lo, hi, G):
            gn = min(G, hi - g0)

            def run_batch(g0=g0, entry_dev=entry_dev):
                if fault_injector is not None:
                    fault_injector.check(g0)
                # Stage real blocks PAST the range end for a ragged final
                # batch: a token starting before span_end may overhang into
                # the next host's bytes, and its next-char gather reads the
                # staged block space — zero padding there would corrupt the
                # boundary token.  valid_total still caps token starts at
                # the range end, so the extra blocks emit nothing.
                gn_stage = min(G, nb - g0)
                gb, gh, gr, ga, gv = codec_model._batch_inputs(
                    x, n, g0, gn_stage, G, B, H, R
                )
                vt = min(G * B, span_end - g0 * B)
                return fused_lib.encode_batch_device(
                    jnp.asarray(gb), jnp.asarray(gh), jnp.asarray(gr),
                    jnp.asarray(ga), jnp.asarray(gv),
                    jnp.int32(vt), entry_dev,
                    la=params.la, sb=params.sb, matcher=matcher,
                    with_map=True, head_w=RESYNC_WINDOW,
                )

            out = faults_lib.with_retries(run_batch, retries=retries)
            payload_d, counts_b, total_d, exit_d, bmap_d, lh_d, oh_d = out
            entry_dev = exit_d
            tot = int(np.asarray(total_d))
            nbytes = tot * nb_bytes
            if nbytes:
                bk = min(fused_lib._bucket(nbytes), payload_d.shape[0])
                parts.append(np.asarray(payload_d[:bk])[:nbytes].tobytes())
            counts[g0 : g0 + gn] = np.asarray(counts_b)[:gn]
            bmap = np.asarray(bmap_d).astype(np.int64)
            cum_map = bmap[cum_map]
            if g0 == lo:
                head["L"] = np.asarray(lh_d)
                head["O"] = np.asarray(oh_d)
        payload = (
            np.frombuffer(b"".join(parts), np.uint8)
            if parts else np.zeros(0, np.uint8)
        )
        return counts, payload, cum_map, head

    t_work0 = time.perf_counter()
    c_work0 = time.process_time()
    counts, payload, cum_map, head = run_range(0)
    t_work = time.perf_counter() - t_work0
    c_work = time.process_time() - c_work0

    # One collective: exact (la,) range maps -> my true entry.
    all_maps = np.asarray(
        multihost_utils.process_allgather(cum_map.astype(np.int32))
    ).reshape(nproc, la)
    entry = 0
    for h in range(pid):
        entry = int(all_maps[h][entry])

    t_work0 = time.perf_counter()
    c_work0 = time.process_time()
    if entry > 0 and my_span > 0:
        # w_eff <= B keeps the splice inside block ``lo`` (the counts
        # adjustment below touches only that block's token count).
        w_eff = min(RESYNC_WINDOW, my_span, B)
        spliced = False
        if native_lib.available() and my_span > w_eff:
            # True-entry parse over the head window; speculative starts
            # from the payload's leading tokens (each token covers >= 1
            # byte, so w_eff tokens always span the window).
            Lh = head["L"][:w_eff]
            Oh = head["O"][:w_eff]
            starts, _ = native_lib.parse_block(
                Lh.astype(np.uint8), w_eff, entry
            )
            starts = np.asarray(starts)
            k = min(int(counts[lo:hi].sum()), w_eff)
            _, len0, _ = native_lib.unpack_tokens(
                payload[: k * nb_bytes], params
            )
            s0_all = np.concatenate(
                [[0], np.cumsum(len0.astype(np.int64) + 1)[:-1]]
            )
            s0 = s0_all[s0_all < w_eff]
            common = np.intersect1d(starts, s0)
            if common.shape[0]:
                m = int(common[0])
                pre = starts[starts < m]
                r = int(np.searchsorted(s0, m))
                xs = x[lo * B : min(n, lo * B + w_eff + la)]
                if xs.shape[0] < w_eff + la:
                    xs = np.concatenate(
                        [xs, np.zeros(w_eff + la - xs.shape[0], np.uint8)]
                    )
                ln_h = Lh[pre].astype(np.int64)
                off_h = Oh[pre].astype(np.int64)
                nxt_h = xs[pre + ln_h].astype(np.int64)
                head_bytes = bitio.tokens_to_bytes(
                    off_h, ln_h, nxt_h, params
                )
                payload = np.concatenate(
                    [head_bytes, payload[r * nb_bytes :]]
                )
                # the splice lives inside the first block (w_eff <= B)
                counts[lo] += pre.shape[0] - r
                spliced = True
        if not spliced:
            # tiny range or adversarial never-resync: exact re-run from the
            # true entry (the maps already gave downstream hosts their
            # exact entries, so this stays a local fixup).
            counts, payload, _, _ = run_range(entry)
    if work_seconds is not None:
        work_seconds.append({
            "wall": t_work + (time.perf_counter() - t_work0),
            "cpu": c_work + (time.process_time() - c_work0),
        })
    return counts, payload, int(payload.shape[0]) * 8


def encode_bytes_multihost(
    data: bytes,
    params: spec.Params | None = None,
    *,
    block_size: int = codec_model.DEFAULT_BLOCK_SIZE,
    batch_blocks: int = codec_model.DEFAULT_BATCH_BLOCKS,
    matcher: str | None = None,
    retries: int = 2,
    fault_injector=None,
    work_seconds: list | None = None,
    force: bool = False,
    pipeline: str = "auto",
) -> bytes | None:
    """Encode with blocks partitioned across JAX processes (in-memory API).

    Every process matches and parses only its contiguous block range; the
    stream is identical to the single-host encoder's (exact global parse via
    the entry-map composition).  Payloads are collected to process 0 in rank
    order at their EXACT sizes (one broadcast per host — no padding to the
    global max).  Process 0 returns the stream; other processes return None.

    For file outputs prefer :func:`encode_file_multihost`, which ships zero
    payload bytes between hosts (each host pwrites its own segment).
    """
    params = params or spec.Params()
    nproc = jax.process_count()
    if nproc == 1 and not force:
        # Solo fast path (``force=True`` keeps the distributed pipeline for
        # apples-to-apples scaling measurements; collectives are no-ops).
        return codec_model.encode_bytes(
            data, params, block_size=block_size, batch_blocks=batch_blocks,
            matcher=matcher, retries=retries,
        )

    from jax.experimental import multihost_utils

    pid = jax.process_index()
    x = np.frombuffer(data, dtype=np.uint8)
    n = x.shape[0]
    _, payload, nbits = _range_encoder(params, pipeline)(
        x, n, params, block_size=block_size, batch_blocks=batch_blocks,
        matcher=matcher, retries=retries, fault_injector=fault_injector,
        work_seconds=work_seconds,
    )

    # Ordered exact-size collection: allgather the (tiny) sizes, then one
    # rank-ordered broadcast per host of exactly its payload.
    sizes = np.asarray(
        multihost_utils.process_allgather(
            np.array([payload.shape[0], nbits], np.int64)
        )
    ).reshape(nproc, 2)
    parts: list[np.ndarray] = []
    for h in range(nproc):
        nbytes_h = int(sizes[h, 0])
        if nbytes_h == 0:
            continue
        buf = payload if pid == h else np.zeros(nbytes_h, np.uint8)
        got = np.asarray(
            multihost_utils.broadcast_one_to_all(buf, is_source=(pid == h))
        )
        if pid == 0:
            parts.append(got)

    if pid != 0:
        return None
    if bitio.byte_aligned(params):
        return bitio.assemble_stream(parts, params)
    bit_parts = [
        p[: int(sizes[h, 1])]
        for h, p in zip(
            [h for h in range(nproc) if sizes[h, 0] > 0], parts
        )
    ]
    return bitio.assemble_stream(bit_parts, params)


def encode_file_multihost(
    in_path: str,
    out_path: str,
    params: spec.Params | None = None,
    *,
    block_size: int = codec_model.DEFAULT_BLOCK_SIZE,
    batch_blocks: int = codec_model.DEFAULT_BATCH_BLOCKS,
    matcher: str | None = None,
    retries: int = 2,
    pipeline: str = "auto",
) -> None:
    """Multi-host file encode over a shared filesystem: ordered parallel
    writes, zero inter-host payload traffic.

    Global bit offsets are affine in the allgathered token counts
    (SURVEY.md §7 insight 1), so every host knows its segment's position:
    it ``pwrite``s its full bytes directly into the output file.  For
    non-byte-aligned widths each host's boundary byte straddles two hosts'
    bits; the (tiny) partial-byte values are allgathered and process 0
    merges them.  The result is byte-identical to the single-host stream.
    """
    import os

    from jax.experimental import multihost_utils

    params = params or spec.Params()
    nproc = jax.process_count()
    pid = jax.process_index()
    n = os.path.getsize(in_path)
    x = (
        np.memmap(in_path, dtype=np.uint8, mode="r")
        if n
        else np.zeros(0, np.uint8)
    )
    counts_mine, payload, nbits = _range_encoder(params, pipeline)(
        x, n, params, block_size=block_size, batch_blocks=batch_blocks,
        matcher=matcher, retries=retries,
    )
    counts = np.asarray(
        multihost_utils.process_allgather(counts_mine)
    ).reshape(nproc, -1).sum(axis=0)

    nb_blocks = counts.shape[0]
    lo, hi = block_range(nb_blocks, nproc, pid)
    W = params.width
    tokens_before = int(counts[:lo].sum())
    my_tokens = int(counts[lo:hi].sum())
    total_tokens = int(counts.sum())
    start_bit = spec.HEADER_BITS + W * tokens_before
    end_bit = start_bit + W * my_tokens
    total_bytes = spec.stream_size_bytes(total_tokens, W)

    if pid == 0:
        with open(out_path, "wb") as f:
            f.write(bitio.header_bytes(params))
            f.truncate(total_bytes)
    # Barrier: the file must exist at full size before anyone pwrites.
    multihost_utils.process_allgather(np.zeros(1, np.int32))

    partial = np.zeros(3, np.int64)  # (byte_index, value, nbits_in_byte)
    fd = os.open(out_path, os.O_WRONLY)
    try:
        if bitio.byte_aligned(params):
            if payload.shape[0]:
                os.pwrite(fd, payload.tobytes(), start_bit // 8)
        else:
            # Shift my bit array so it starts at its in-byte offset; my
            # first byte may straddle the previous host's bits and my last
            # byte the next host's — exclude both from the pwrite and route
            # them through the partial-byte merge.
            head_pad = start_bit % 8
            bits = np.concatenate(
                [np.zeros(head_pad, np.uint8), payload[:nbits]]
            )
            by = np.packbits(bits, bitorder="little")
            first_byte = start_bit // 8
            last_bit = end_bit - 1
            lo_i = 0
            hi_i = by.shape[0]
            if head_pad and by.shape[0]:
                partial_head = (first_byte, int(by[0]), head_pad)
                lo_i = 1
            else:
                partial_head = None
            tail_bits = end_bit % 8
            if tail_bits and by.shape[0] > lo_i:
                partial_tail = (last_bit // 8, int(by[-1]), tail_bits)
                hi_i -= 1
            else:
                partial_tail = None
            if hi_i > lo_i:
                os.pwrite(fd, by[lo_i:hi_i].tobytes(), first_byte + lo_i)
            # A host contributes at most two partial bytes; encode both in
            # one fixed-size record for the allgather (value<<8 | count).
            rec = []
            for p in (partial_head, partial_tail):
                rec.append(
                    (-1, 0, 0) if p is None else p
                )
            partial = np.array(rec, np.int64).reshape(-1)
        os.fsync(fd)
    finally:
        os.close(fd)

    if not bitio.byte_aligned(params):
        allp = np.asarray(
            multihost_utils.process_allgather(partial)
        ).reshape(nproc, 2, 3)
        if pid == 0:
            merged: dict[int, int] = {}
            for h in range(nproc):
                for k in range(2):
                    idx, val, _ = allp[h, k]
                    if idx >= 0:
                        merged[int(idx)] = merged.get(int(idx), 0) | int(val)
            fd = os.open(out_path, os.O_WRONLY)
            try:
                for idx, val in sorted(merged.items()):
                    os.pwrite(fd, bytes([val]), idx)
                os.fsync(fd)
            finally:
                os.close(fd)
    # Final barrier: every process returns only after the file is complete.
    multihost_utils.process_allgather(np.zeros(1, np.int32))
