"""File-level codec: block decomposition, batching, stream assembly.

Encode path (SURVEY.md §7 phases 1-2):

  input bytes -> fixed-size blocks (+ halo of preceding and la-1 following
                 input bytes)
             -> batched device match tables (the O(n * sb) hot phase,
                jit + vmap, embarrassingly parallel)
             -> host global greedy parse: per-block pointer-doubling orbit
                with an entry-offset carry chaining blocks (O(n) gathers)
             -> device gather of offsets at token starts
             -> host bit-pack of each block's tokens (affine offsets)
             -> single concatenated stream: header + tokens + padding.

Because every block's match table sees the true preceding bytes (halo) and
following bytes (right extension), per-position results are identical to a
single serial pass, and the entry-carried parse is *exactly* the global
greedy parse: the emitted stream is byte-identical to the numpy executable
spec and its token count is <= the reference BST encoder's (SURVEY.md §2.4).

Transfer discipline: every byte crossing the host<->device link costs time,
so the device returns nibble-packed match lengths (half a byte per input
byte) and offsets are fetched only at token starts (~T*2 bytes).  A two-deep
software pipeline overlaps device matching of batch k+1 with host parsing of
batch k.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from .. import bitio, spec
from .. import native as native_lib
from ..utils import faults as faults_lib
from ..utils import metrics as metrics_lib
from . import decoder as decoder_model
from . import encoder as encoder_model

DEFAULT_BLOCK_SIZE = 1 << 16
DEFAULT_BATCH_BLOCKS = 8
_IDX_BUCKET = 1 << 14
_NATIVE = native_lib.available()


@dataclasses.dataclass
class EncodeStats:
    """Per-run observability record (the reference has none — SURVEY.md §5)."""

    input_bytes: int = 0
    output_bytes: int = 0
    tokens: int = 0
    blocks: int = 0
    retries: int = 0
    # Whether memmap page release (flat-RSS streaming) is active on this
    # run — False when the input is not a memmap or the private
    # numpy/mmap surface changed (makes RSS regressions diagnosable).
    page_release: bool = False
    # Host<->device transfer accounting (fused/sharded pipelines): bytes
    # staged to the device and bytes fetched back.  The per-input-byte
    # traffic ratio explains how much of the end-to-end time the host link
    # takes (docs/BIGRUN.md).
    h2d_bytes: int = 0
    d2h_bytes: int = 0
    phases: metrics_lib.PhaseTimes = dataclasses.field(
        default_factory=metrics_lib.PhaseTimes
    )

    @property
    def ratio(self) -> float:
        return self.output_bytes / self.input_bytes if self.input_bytes else 0.0


def _orbit_np(J: np.ndarray, entry: int, steps: int) -> np.ndarray:
    """S[i] = f^i(entry) for i in [0, steps], via pointer doubling."""
    S = np.zeros(steps + 1, np.int64)
    S[0] = entry
    m = 1
    Jm = J
    while m <= steps:
        span = min(m, steps + 1 - m)
        S[m : m + span] = Jm[S[:span]]
        Jm = Jm[Jm]
        m *= 2
    return S


def parse_block_np(
    L: np.ndarray, valid_len: int, entry: int, la: int
) -> tuple[np.ndarray, int]:
    """Host-side greedy parse of one block: (token starts, exit position).

    Mirrors ``ops.parse.greedy_parse`` (same orbit, numpy): jump table
    f(p) = p + L[p] + 1 below ``valid_len``, fixpoints at/after it.
    """
    B = L.shape[0]
    BE = B + la
    pos = np.arange(BE, dtype=np.int64)
    Lp = np.concatenate([L.astype(np.int64), np.zeros(la, np.int64)])
    J = np.where(pos < valid_len, np.minimum(pos + Lp + 1, BE - 1), pos)
    if entry >= valid_len:
        return np.zeros(0, np.int64), entry
    S = _orbit_np(J, entry, B)
    starts = S[:B][S[:B] < valid_len]
    return starts, int(S[B])


def _batch_inputs(x: np.ndarray, n: int, g0: int, gn: int, G: int, B: int,
                  H: int, R: int):
    gb = np.zeros((G, B), np.uint8)
    gh = np.zeros((G, H), np.uint8)
    gr = np.zeros((G, R), np.uint8)
    ga = np.zeros(G, np.int32)
    gv = np.zeros(G, np.int32)
    for i in range(gn):
        gs = (g0 + i) * B
        seg = x[gs : min(gs + B, n)]
        gb[i, : seg.shape[0]] = seg
        a = min(H, gs)
        if a > 0:
            gh[i, H - a :] = x[gs - a : gs]
        rseg = x[gs + B : min(gs + B + R, n)]
        gr[i, : rseg.shape[0]] = rseg
        ga[i] = a
        gv[i] = min(B + R, n - gs)
    return gb, gh, gr, ga, gv


def iter_block_bits(
    x: np.ndarray,
    params: spec.Params,
    *,
    block_size: int = DEFAULT_BLOCK_SIZE,
    batch_blocks: int = DEFAULT_BATCH_BLOCKS,
    matcher: str | None = None,
    match_fn=None,
    retries: int = 2,
    fault_injector: faults_lib.FaultInjector | None = None,
    start_block: int = 0,
    entry: int = 0,
    phases: metrics_lib.PhaseTimes | None = None,
):
    """Yield (block_index, entry, next_entry, token_count, bit_array) per block.

    The core encode loop: batched device match phase, host entry-carried
    parse, device offset gather, host bit-pack.  A two-deep software pipeline
    overlaps device matching of batch k+1 with host parsing of batch k.
    ``start_block``/``entry`` allow resuming mid-stream (utils.manifest).
    Failed device batches are retried ``retries`` times (blocks are
    independent up to the scalar entry carry — SURVEY.md §5).
    """
    n = x.shape[0]
    B = block_size
    if B % 2:
        raise ValueError("block_size must be even (nibble packing)")
    H = params.d_limit
    R = params.len_limit
    la = params.la
    nb = -(-n // B)
    G = batch_blocks
    first_batch = start_block // G
    if start_block % G:
        raise ValueError("start_block must be a multiple of batch_blocks")
    num_batches = -(-nb // G)

    def submit(bi: int):
        g0 = bi * G
        gn = min(G, nb - g0)
        gb, gh, gr, ga, gv = _batch_inputs(x, n, g0, gn, G, B, H, R)
        if match_fn is not None:
            L, O = match_fn(gb, gh, gr, ga, gv)
            return ("full", bi, gn, L, O)
        packed, O16 = encoder_model.match_blocks_compact(
            jnp.asarray(gb), jnp.asarray(gh), jnp.asarray(gr),
            jnp.asarray(ga), jnp.asarray(gv),
            la=params.la, sb=params.sb, matcher=matcher,
        )
        return ("compact", bi, gn, packed, O16)

    state = {"entry": entry}
    ph = phases if phases is not None else metrics_lib.PhaseTimes()

    def process(handle):
        kind, bi, gn, a1, a2 = handle
        g0 = bi * G
        with metrics_lib.StopwatchPhase(ph, "match"):
            if kind == "full":
                Lg, Og = np.asarray(a1), np.asarray(a2)
            else:
                packed_np = np.asarray(a1)  # the only bulk fetch: ~B/2/block
        all_starts: list[np.ndarray] = []
        all_lens: list[np.ndarray] = []
        entries: list[tuple[int, int]] = []
        sw = metrics_lib.StopwatchPhase(ph, "parse")
        sw.__enter__()
        for i in range(gn):
            gs = (g0 + i) * B
            vl = min(B, n - gs)
            if kind == "full":
                L = Lg[i]
            else:
                L = encoder_model.unpack_lengths(packed_np[i], B, la)
            e_in = state["entry"]
            if _NATIVE:
                starts, exit_pos = native_lib.parse_block(L, vl, e_in)
            else:
                starts, exit_pos = parse_block_np(L, vl, e_in, la)
            state["entry"] = max(0, exit_pos - B)
            entries.append((e_in, state["entry"]))
            all_starts.append(starts)
            all_lens.append(L[starts] if starts.shape[0] else
                            np.zeros(0, np.uint8))
        sw.__exit__()
        counts = [s.shape[0] for s in all_starts]
        if sum(counts) == 0:
            off_cat = np.zeros(0, np.int64)
        elif kind == "full":
            off_cat = np.concatenate(
                [Og[i][all_starts[i]] for i in range(gn)]
            )
        else:
            flat = np.concatenate(
                [i * B + s for i, s in enumerate(all_starts)]
            ).astype(np.int32)
            pad = -(-flat.shape[0] // _IDX_BUCKET) * _IDX_BUCKET
            flat_p = np.zeros(pad, np.int32)
            flat_p[: flat.shape[0]] = flat
            off_cat = np.asarray(
                encoder_model.gather_offsets(a2, jnp.asarray(flat_p))
            )[: flat.shape[0]]
        results = []
        c0 = 0
        sw2 = metrics_lib.StopwatchPhase(ph, "pack")
        sw2.__enter__()
        for i in range(gn):
            c = counts[i]
            gs = (g0 + i) * B
            starts = all_starts[i]
            ln = all_lens[i].astype(np.int64)
            off = off_cat[c0 : c0 + c].astype(np.int64)
            nx = x[gs + starts + ln] if c else np.zeros(0, np.uint8)
            if _NATIVE and bitio.byte_aligned(params):
                chunk, _bits = native_lib.pack_tokens(off, ln, nx, params)
            else:
                chunk = bitio.tokens_to_chunk(off, ln, nx, params)
            e_in, e_out = entries[i]
            results.append((g0 + i, e_in, e_out, c, chunk))
            c0 += c
        sw2.__exit__()
        return results

    pending = None
    for bi in range(first_batch, num_batches):
        with metrics_lib.StopwatchPhase(ph, "io"):
            if fault_injector is not None:
                def submit_checked(b=bi):
                    fault_injector.check(b)
                    return submit(b)
                nxt = faults_lib.with_retries(submit_checked, retries=retries)
            else:
                nxt = faults_lib.with_retries(submit, bi, retries=retries)
        if pending is not None:
            yield from process(pending)
        pending = nxt
    if pending is not None:
        yield from process(pending)


def encode_bytes(
    data: bytes,
    params: spec.Params | None = None,
    *,
    block_size: int = DEFAULT_BLOCK_SIZE,
    batch_blocks: int = DEFAULT_BATCH_BLOCKS,
    matcher: str | None = None,
    stats: EncodeStats | None = None,
    match_fn=None,
    retries: int = 2,
    fault_injector: faults_lib.FaultInjector | None = None,
) -> bytes:
    """Compress ``data`` into a complete reference-format stream."""
    params = params or spec.Params()
    x = np.frombuffer(data, dtype=np.uint8)
    n = x.shape[0]
    st = stats if stats is not None else EncodeStats()
    st.input_bytes = n

    with metrics_lib.StopwatchPhase(st.phases, "total"):
        chunks: list[np.ndarray] = []
        total_tokens = 0
        if n > 0:
            for _, _, _, c, chunk in iter_block_bits(
                x, params, block_size=block_size, batch_blocks=batch_blocks,
                matcher=matcher, match_fn=match_fn, retries=retries,
                fault_injector=fault_injector, phases=st.phases,
            ):
                total_tokens += c
                if chunk.shape[0]:
                    chunks.append(chunk)

        st.tokens = total_tokens
        st.blocks = -(-n // block_size)
        stream = bitio.assemble_stream(chunks, params)
        st.output_bytes = len(stream)
    return stream


class _PageReleaser:
    """Drop consumed memmap pages as the encode scan advances.

    Without this, sequentially-read file-backed pages stay resident and peak
    RSS grows with the INPUT size (the 1 GB conformance run measured
    ~input-proportional RSS before, flat after).  MADV_DONTNEED on a
    read-only private mapping just re-reads on any later touch, so it is
    safe even if something looks back.  ``active`` records whether the
    private ``x._mmap``/``madvise`` surface is actually present (a numpy
    change would otherwise silently disable flat-RSS behavior — the flag
    makes RSS regressions diagnosable from EncodeStats).
    """

    def __init__(self, x: np.ndarray, keep_margin: int):
        import mmap as mmap_lib

        self._mm = getattr(x, "_mmap", None)
        self._margin = keep_margin
        self._released = 0
        self._page = mmap_lib.PAGESIZE
        self._dontneed = getattr(mmap_lib, "MADV_DONTNEED", None)
        self.active = (
            self._mm is not None
            and self._dontneed is not None
            and hasattr(self._mm, "madvise")
        )

    def release_to(self, byte_pos: int) -> None:
        """Release pages wholly before ``byte_pos - keep_margin``."""
        if not self.active:
            return
        keep_from = max(0, byte_pos - self._margin)
        end = (keep_from // self._page) * self._page
        if end > self._released:
            start = self._released
            self._released = end
            try:
                self._mm.madvise(self._dontneed, start, end - start)
            except (OSError, ValueError):
                self.active = False  # optimization only, never correctness


def encode_file(
    in_path: str,
    out_path: str,
    params: spec.Params | None = None,
    *,
    block_size: int = DEFAULT_BLOCK_SIZE,
    batch_blocks: int = DEFAULT_BATCH_BLOCKS,
    matcher: str | None = None,
    stats: EncodeStats | None = None,
    manifest_path: str | None = None,
    resume: bool = False,
    retries: int = 2,
    fault_injector: faults_lib.FaultInjector | None = None,
    pipeline: str = "host",
    mesh=None,
) -> None:
    """File-to-file encode with optional checkpoint/resume.

    With ``manifest_path``, each completed block's token bits are appended
    (byte-aligned) to ``out_path + '.partial'`` and the manifest records
    (tokens, bit offset, entry offsets) per block — SURVEY.md §5's
    checkpoint story.  On ``resume=True`` a compatible manifest skips every
    completed batch and continues from the recorded parse entry.  The final
    stream is assembled bit-contiguously, then scratch files are removed.

    ``pipeline`` selects the encode engine at file scale: 'host' = device
    match + host parse (this function's classic path); 'fused' = the
    device-resident match+parse+pack pipeline; 'sharded' = the exact
    multi-device pipeline over ``mesh``.  The fused and sharded engines
    checkpoint at BATCH granularity (one manifest record
    per device batch) and require a byte-aligned token width.
    """
    import os
    import time as time_lib

    from ..utils import manifest as manifest_lib

    _t0 = time_lib.perf_counter()
    params = params or spec.Params()
    if pipeline not in ("host", "fused", "sharded"):
        raise ValueError(f"unknown pipeline {pipeline!r}")
    if pipeline != "host":
        return _encode_file_batched(
            in_path, out_path, params, pipeline=pipeline,
            block_size=block_size, batch_blocks=batch_blocks,
            matcher=matcher, stats=stats, manifest_path=manifest_path,
            resume=resume, fault_injector=fault_injector, mesh=mesh,
        )
    # Memory-map the input and stream the output: blocks are read on demand
    # through OS paging and each completed block's payload is written to the
    # output file immediately, so both sides run in bounded memory for inputs
    # far larger than RAM.
    n = os.path.getsize(in_path)
    x = (
        np.memmap(in_path, dtype=np.uint8, mode="r")
        if n
        else np.zeros(0, np.uint8)
    )
    st = stats if stats is not None else EncodeStats()
    st.input_bytes = n

    releaser = _PageReleaser(x, keep_margin=params.d_limit)
    st.page_release = releaser.active

    def _release_consumed(next_block: int) -> None:
        releaser.release_to(next_block * block_size)

    if manifest_path is None:
        total_tokens = 0
        aligned = bitio.byte_aligned(params)
        out_bytes = spec.HEADER_BYTES
        with open(out_path, "wb") as f:
            f.write(bitio.header_bytes(params))
            rem = np.zeros(0, np.uint8)  # carried sub-byte bits (non-aligned)
            if n > 0:
                for bidx, _, _, c, chunk in iter_block_bits(
                    x, params, block_size=block_size,
                    batch_blocks=batch_blocks, matcher=matcher,
                    retries=retries, fault_injector=fault_injector,
                    phases=st.phases,
                ):
                    total_tokens += c
                    if (bidx + 1) % batch_blocks == 0:
                        _release_consumed(bidx + 1)
                    if not chunk.shape[0]:
                        continue
                    if aligned:
                        f.write(chunk.tobytes())
                        out_bytes += chunk.shape[0]
                    else:
                        bits = np.concatenate([rem, chunk])
                        whole = (bits.shape[0] // 8) * 8
                        if whole:
                            f.write(
                                np.packbits(
                                    bits[:whole], bitorder="little"
                                ).tobytes()
                            )
                            out_bytes += whole // 8
                        rem = bits[whole:]
            if rem.shape[0]:
                # Final partial byte, zero-padded (bitIO_close, bitio.c:180-182).
                f.write(np.packbits(rem, bitorder="little").tobytes())
                out_bytes += 1
        st.tokens = total_tokens
        st.blocks = -(-n // block_size)
        st.output_bytes = out_bytes
        st.phases.total = time_lib.perf_counter() - _t0
        return

    scratch_path = out_path + ".partial"
    man = None
    if resume and os.path.exists(manifest_path):
        try:
            cand = manifest_lib.Manifest.load(manifest_path)
            if cand.compatible_with(params, block_size, n):
                man = cand
        except Exception:
            man = None
    if man is None:
        man = manifest_lib.Manifest(
            la=params.la, sb=params.sb, block_size=block_size, input_bytes=n
        )
        open(scratch_path, "wb").close()

    # Resume can only restart at a batch boundary: drop trailing records
    # past the last full batch and truncate scratch accordingly.
    done = man.completed()
    done -= done % batch_blocks
    man.blocks = man.blocks[:done]
    scratch_bytes = sum((b.tokens * man.width + 7) // 8 for b in man.blocks)
    # A manifest without its scratch payload (deleted/truncated .partial)
    # must restart: open('ab') would recreate it and f.truncate would
    # zero-extend, silently replacing completed blocks with zeros.
    if scratch_bytes and (
        not os.path.exists(scratch_path)
        or os.path.getsize(scratch_path) < scratch_bytes
    ):
        man.blocks = []
        done = 0
        scratch_bytes = 0
        open(scratch_path, "wb").close()
    with open(scratch_path, "ab") as f:
        f.truncate(scratch_bytes)

    entry = man.next_entry()
    total_tokens = sum(b.tokens for b in man.blocks)
    if n > 0:
        aligned = bitio.byte_aligned(params)
        with open(scratch_path, "ab") as scratch:
            for bidx, e_in, e_out, c, chunk in iter_block_bits(
                x, params, block_size=block_size, batch_blocks=batch_blocks,
                matcher=matcher, retries=retries,
                fault_injector=fault_injector,
                start_block=done, entry=entry,
            ):
                if aligned:
                    scratch.write(chunk.tobytes())
                else:
                    scratch.write(
                        np.packbits(chunk, bitorder="little").tobytes()
                    )
                man.append(c, e_in, e_out)
                total_tokens += c
                if (bidx + 1) % batch_blocks == 0:
                    scratch.flush()
                    man.save(manifest_path)
                    _release_consumed(bidx + 1)

    # Final assembly, in bounded memory (the scratch file can exceed RAM):
    # byte-aligned widths stream-copy scratch after the header; non-aligned
    # widths merge each record's bits with a carried sub-byte remainder —
    # the same merge the non-manifest path does batch-by-batch above.
    aligned = bitio.byte_aligned(params)
    out_bytes = spec.HEADER_BYTES
    with open(out_path, "wb") as f:
        f.write(bitio.header_bytes(params))
        with open(scratch_path, "rb") as sf:
            if aligned:
                while True:
                    buf = sf.read(64 << 20)
                    if not buf:
                        break
                    f.write(buf)
                    out_bytes += len(buf)
            else:
                rem = np.zeros(0, np.uint8)
                for rec in man.blocks:
                    nbytes = (rec.tokens * man.width + 7) // 8
                    raw = np.frombuffer(sf.read(nbytes), np.uint8)
                    bits = np.concatenate([
                        rem,
                        np.unpackbits(raw, bitorder="little")[
                            : rec.tokens * man.width
                        ],
                    ])
                    whole = (bits.shape[0] // 8) * 8
                    if whole:
                        f.write(
                            np.packbits(
                                bits[:whole], bitorder="little"
                            ).tobytes()
                        )
                        out_bytes += whole // 8
                    rem = bits[whole:]
                if rem.shape[0]:
                    f.write(np.packbits(rem, bitorder="little").tobytes())
                    out_bytes += 1
    os.unlink(scratch_path)
    if os.path.exists(manifest_path):
        os.unlink(manifest_path)

    st.tokens = total_tokens
    st.blocks = -(-n // block_size)
    st.output_bytes = out_bytes
    st.phases.total = time_lib.perf_counter() - _t0


def _encode_file_batched(
    in_path: str,
    out_path: str,
    params: spec.Params,
    *,
    pipeline: str,
    block_size: int,
    batch_blocks: int,
    matcher: str,
    stats: EncodeStats | None,
    manifest_path: str | None,
    resume: bool,
    fault_injector: faults_lib.FaultInjector | None,
    mesh,
) -> None:
    """File-to-file encode through the fused or sharded device pipeline.

    The device-resident pipelines (match + parse + pack on device) at file
    scale: memmap input with page release, payload bytes appended as each
    batch lands, one manifest record per BATCH (the device step's natural
    checkpoint unit).  Replaces lz77.c:89-136 + 246-251 for inputs larger
    than RAM — the host moves ~0.5 B per input byte instead of ~2-3.
    """
    import os
    import time as time_lib

    from ..utils import manifest as manifest_lib

    _t0 = time_lib.perf_counter()
    if params.width % 8 != 0:
        raise ValueError(
            f"pipeline={pipeline!r} requires a byte-aligned token width "
            f"(width={params.width}); use pipeline='host'"
        )
    n = os.path.getsize(in_path)
    x = (
        np.memmap(in_path, dtype=np.uint8, mode="r")
        if n
        else np.zeros(0, np.uint8)
    )
    st = stats if stats is not None else EncodeStats()
    st.input_bytes = n

    if pipeline == "sharded":
        from ..parallel import mesh as mesh_lib
        from ..parallel import sharded as sharded_lib

        if mesh is None:
            mesh = mesh_lib.make_mesh()
        if batch_blocks % mesh.shape[mesh_lib.DATA_AXIS]:
            raise ValueError(
                f"batch_blocks={batch_blocks} must be a multiple of the "
                f"data-axis size {mesh.shape[mesh_lib.DATA_AXIS]}"
            )

        def make_iter(start_batch: int, entry: int):
            return sharded_lib.iter_batches_sharded(
                x, params, mesh=mesh, block_size=block_size,
                batch_blocks=batch_blocks, matcher=matcher,
                start_batch=start_batch, entry=entry, stats=st,
            )
    else:
        from . import fused as fused_lib

        def make_iter(start_batch: int, entry: int):
            return fused_lib.iter_batches_fused(
                x, params, block_size=block_size,
                batch_blocks=batch_blocks, matcher=matcher,
                start_batch=start_batch, entry=entry, stats=st,
            )

    releaser = _PageReleaser(x, keep_margin=params.d_limit)
    st.page_release = releaser.active
    span = batch_blocks * block_size  # bytes per batch

    def run_batches(sink, start_batch: int, entry: int, on_batch=None):
        total_tokens = 0
        for bi, e_in, e_out, tok, payload in make_iter(start_batch, entry):
            if fault_injector is not None:
                fault_injector.check(bi)
            total_tokens += tok
            if payload:
                sink.write(payload)
            if on_batch is not None:
                on_batch(bi, e_in, e_out, tok)
            releaser.release_to((bi + 1) * span)
        return total_tokens

    if manifest_path is None:
        with open(out_path, "wb") as f:
            f.write(bitio.header_bytes(params))
            total_tokens = run_batches(f, 0, 0) if n > 0 else 0
            out_bytes = f.tell()
        st.tokens = total_tokens
        st.blocks = -(-n // block_size)
        st.output_bytes = out_bytes
        st.phases.total = time_lib.perf_counter() - _t0
        return

    scratch_path = out_path + ".partial"
    man = None
    if resume and os.path.exists(manifest_path):
        try:
            cand = manifest_lib.Manifest.load(manifest_path)
            if cand.compatible_with(
                params, block_size, n, pipeline=pipeline,
                batch_blocks=batch_blocks,
            ):
                man = cand
        except Exception:
            man = None
    if man is None:
        man = manifest_lib.Manifest(
            la=params.la, sb=params.sb, block_size=block_size,
            input_bytes=n, pipeline=pipeline, batch_blocks=batch_blocks,
        )
        open(scratch_path, "wb").close()

    # Batch records are the checkpoint unit: drop nothing (each record is a
    # completed batch), truncate scratch to the recorded payload bytes.
    done = man.completed()
    man.blocks = man.blocks[:done]
    scratch_bytes = sum((b.tokens * man.width) // 8 for b in man.blocks)
    # A manifest without its scratch payload (deleted/truncated .partial)
    # must restart: open('ab') would recreate it and f.truncate would
    # zero-extend, silently replacing completed batches with zeros.
    if scratch_bytes and (
        not os.path.exists(scratch_path)
        or os.path.getsize(scratch_path) < scratch_bytes
    ):
        man.blocks = []
        done = 0
        scratch_bytes = 0
        open(scratch_path, "wb").close()
    with open(scratch_path, "ab") as f:
        f.truncate(scratch_bytes)

    entry = man.next_entry()
    total_tokens = sum(b.tokens for b in man.blocks)
    if n > 0:
        with open(scratch_path, "ab") as scratch:

            def checkpoint(bi, e_in, e_out, tok):
                scratch.flush()
                man.append(tok, e_in, e_out)
                man.save(manifest_path)

            total_tokens += run_batches(scratch, done, entry, checkpoint)

    # Final assembly: byte-aligned payloads stream-copy after the header.
    out_bytes = spec.HEADER_BYTES
    with open(out_path, "wb") as f:
        f.write(bitio.header_bytes(params))
        with open(scratch_path, "rb") as sf:
            while True:
                buf = sf.read(64 << 20)
                if not buf:
                    break
                f.write(buf)
                out_bytes += len(buf)
    os.unlink(scratch_path)
    if os.path.exists(manifest_path):
        os.unlink(manifest_path)

    st.tokens = total_tokens
    st.blocks = -(-n // block_size)
    st.output_bytes = out_bytes
    st.phases.total = time_lib.perf_counter() - _t0


@dataclasses.dataclass
class DecodeStats:
    """Decode observability: which backend actually ran.

    Records the route a ``backend`` request took (native serial or streamed,
    numpy, or the device decoder) so a caller who is benchmarking can see
    what it measured.
    """

    requested: str = ""
    backend: str = ""
    input_bytes: int = 0
    output_bytes: int = 0


def decode_bytes(
    data: bytes,
    backend: str = "auto",
    *,
    stats: DecodeStats | None = None,
) -> bytes:
    """Decompress a complete reference-format stream.

    ``backend``: 'native' (the serial C decoder), 'host' (vectorized numpy
    pointer-doubling decode), 'device' (the chunked pointer-doubling XLA
    decoder, ``models.decoder``, for every window up to sb=65535), or 'auto'
    (native if built, else host).  The backend actually used is recorded in
    ``stats.backend``.
    """
    st = stats if stats is not None else DecodeStats()
    st.requested = backend
    st.input_bytes = len(data)
    if backend == "auto":
        backend = "native" if _NATIVE else "host"
    if backend == "native":
        out = native_lib.decode(data)
    elif backend == "host":
        from . import host_decode

        out = host_decode.decode(data)
    elif backend == "device":
        out = decoder_model.decode_stream(data)
        backend = "device-xla"
    else:
        raise ValueError(f"unknown decode backend {backend!r}")
    st.backend = backend
    st.output_bytes = len(out)
    return out


def decode_file(
    in_path: str,
    out_path: str,
    backend: str = "auto",
    *,
    stats: DecodeStats | None = None,
    read_chunk: int = 8 << 20,
    out_chunk: int = 4 << 20,
) -> int:
    """File-to-file decode; returns the decoded size.

    The default route is the native streamed decoder: O(window) memory
    regardless of stream size (the reference's decode capability,
    lz77.c:148-197 + bitio.c:103-121 — a 10 GB stream decodes at flat RSS).
    ``backend='device'`` streams through the XLA decoder at bounded host
    memory (:func:`decode_file_device`).  The host backend materializes the
    stream in RAM and dispatches through :func:`decode_bytes`; the routing
    is recorded in ``stats.backend`` either way.
    """
    import os

    st = stats if stats is not None else DecodeStats()
    st.requested = backend
    if backend in ("auto", "native") and _NATIVE:
        st.input_bytes = os.path.getsize(in_path)
        n = native_lib.decode_file(
            in_path, out_path, read_chunk=read_chunk, out_chunk=out_chunk
        )
        st.backend = "native-streamed"
        st.output_bytes = n
        return n
    if backend == "device":
        return decode_file_device(in_path, out_path, stats=st)
    with open(in_path, "rb") as f:
        data = f.read()
    out = decode_bytes(data, backend=backend, stats=st)
    with open(out_path, "wb") as f:
        f.write(out)
    return len(out)


def decode_file_device(
    in_path: str,
    out_path: str,
    *,
    stats: DecodeStats | None = None,
    chunk_tokens: int = decoder_model.DEFAULT_CHUNK_TOKENS,
    read_tokens: int = 1 << 21,
) -> int:
    """File-to-file decode on the device at bounded host memory.

    The stream is read ``read_tokens`` tokens at a time and replayed in
    ``chunk_tokens`` chunks through ``decoder._decode_chunk``, whose window
    tail (the reference's recycled window, lz77.c:172-175) stays on the
    device between chunks.  Each chunk's bytes are fetched and written as
    they land while the next chunk is already queued, so host memory is
    O(window + chunk) at any stream size.

    Offsets are validated against the decoded history before replay (the
    pointer-doubling replay would otherwise copy from the zero-filled tail
    for a corrupt offset); raises ValueError on corrupt streams like the
    native route.
    """
    import os

    from . import fused as fused_lib

    if read_tokens % 8:
        raise ValueError("read_tokens must be a multiple of 8")
    st = stats if stats is not None else DecodeStats()
    st.requested = "device"
    st.input_bytes = os.path.getsize(in_path)

    def write_chunk(fout, handle) -> int:
        out, out_len = handle
        n_out = int(out_len)
        if n_out:
            bk = min(fused_lib._bucket(n_out), out.shape[0])
            fout.write(np.asarray(out[:bk])[:n_out].tobytes())
        return n_out

    with open(in_path, "rb") as f:
        hdr = f.read(spec.HEADER_BYTES)
        if len(hdr) < spec.HEADER_BYTES:
            raise ValueError("corrupt or truncated stream: no header")
        sb = hdr[0] | (hdr[1] << 8)
        la = hdr[2] | (hdr[3] << 8)
        if not (spec.MIN_LA_SIZE <= la <= spec.MAX_LA_SIZE) or not (
            1 <= sb <= spec.MAX_SB_SIZE
        ):
            raise ValueError(f"corrupt stream header: la={la} sb={sb}")
        params = spec.Params(la=la, sb=sb)
        width = params.width
        dlim = params.d_limit
        # Same tail width as decoder.decode_stream: the largest offset the
        # field can hold.
        tail = jnp.zeros(((1 << params.off_bits) - 1,), jnp.uint8)
        hist = 0
        total_out = 0
        # read_tokens % 8 == 0 keeps every file chunk byte-aligned
        # (8 tokens always span a whole number of bytes at any width).
        read_bytes = (read_tokens * width) // 8
        carry = b""
        pending = None
        with open(out_path, "wb") as fout:
            while True:
                buf = f.read(read_bytes)
                if not buf and not carry:
                    break
                chunk = carry + buf
                eof = len(buf) < read_bytes
                T_chunk = (len(chunk) * 8) // width
                if not eof:
                    T_chunk -= T_chunk % 8  # keep the tail byte-aligned
                used_bytes = (
                    len(chunk) if eof else (T_chunk * width) // 8
                )
                carry = b"" if eof else chunk[used_bytes:]
                if T_chunk == 0:
                    if eof:
                        break
                    continue
                off, ln, nxt = bitio.bytes_to_tokens(
                    np.frombuffer(chunk[:used_bytes], np.uint8), T_chunk,
                    params,
                ) if bitio.byte_aligned(params) else bitio.bits_to_tokens(
                    np.unpackbits(
                        np.frombuffer(chunk[:used_bytes], np.uint8),
                        bitorder="little",
                    )[: T_chunk * width],
                    params,
                )
                sizes = ln.astype(np.int64) + 1
                starts = hist + np.cumsum(sizes) - sizes
                # (off is ignored when ln == 0, like every decoder here
                # and the reference's copy loop, lz77.c:178-188)
                bad = (ln > 0) & (
                    (off == 0) | (off > dlim) | (off > starts)
                )
                if bad.any() or (ln > params.len_limit).any():
                    raise ValueError("corrupt stream: invalid token")
                hist += int(sizes.sum())
                for c0 in range(0, T_chunk, chunk_tokens):
                    k = min(chunk_tokens, T_chunk - c0)
                    fields = []
                    for a in (off, ln, nxt):
                        v = np.zeros(chunk_tokens, np.int32)
                        v[:k] = a[c0 : c0 + k]
                        fields.append(jnp.asarray(v))
                    out, out_len, tail = decoder_model._decode_chunk(
                        *fields, jnp.int32(k), tail, la=params.la
                    )
                    if pending is not None:
                        total_out += write_chunk(fout, pending)
                    pending = (out, out_len)
                if eof:
                    break
            if pending is not None:
                total_out += write_chunk(fout, pending)
    st.backend = "device-xla-streamed"
    st.output_bytes = total_out
    return total_out
