"""Block encoder pipeline (device side).

Two device entry points:

* :func:`match_blocks` — the hot phase: exact match tables for a batch of
  independent blocks (jit + vmap).  Blocks depend only on raw input bytes
  (halo + right extension), so this phase is embarrassingly parallel across
  blocks, batches and devices.  The file-level codec pairs it with a global
  host-side parse that chains entry offsets, reproducing the exact serial
  parse (and therefore the size <= reference guarantee).

* :func:`encode_block` — the full single-block pipeline (match -> parse ->
  gather) fused on device; used by the compile-check entry point, tests and
  the sharded demo path where a per-block parse (entry=0) is acceptable.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..ops import match as match_ops
from ..ops import parse as parse_ops


@functools.partial(jax.jit, static_argnames=("la", "sb", "matcher"))
def match_blocks(
    blocks: jnp.ndarray,
    halos: jnp.ndarray,
    rights: jnp.ndarray,
    avails: jnp.ndarray,
    valid_exts: jnp.ndarray,
    *,
    la: int,
    sb: int,
    matcher: str | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(G, B) blocks -> (G, B) match tables (L, O)."""
    find = match_ops.get_matcher(matcher, la)
    fn = functools.partial(find, la=la, sb=sb)
    return jax.vmap(fn)(blocks, halos, rights, avails, valid_exts)


@functools.partial(jax.jit, static_argnames=("la", "sb", "matcher"))
def match_blocks_compact(
    blocks: jnp.ndarray,
    halos: jnp.ndarray,
    rights: jnp.ndarray,
    avails: jnp.ndarray,
    valid_exts: jnp.ndarray,
    *,
    la: int,
    sb: int,
    matcher: str | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Match phase with transfer-minimal outputs.

    Returns (packed_L, O16): packed_L is the per-position match length,
    nibble-packed two-per-byte when la <= 16 (length <= 15 fits 4 bits) or
    one byte per position otherwise — the only array the host needs to run
    the exact global parse; O16 is the uint16 offset table meant to *stay on
    device* until :func:`gather_offsets` picks out the few entries at token
    starts.  Host<->device traffic is the scarce resource (SURVEY.md §3.4's
    process/device boundary, which on an accelerator is the PCIe hop).
    """
    find = match_ops.get_matcher(matcher, la)
    fn = functools.partial(find, la=la, sb=sb)
    L, O = jax.vmap(fn)(blocks, halos, rights, avails, valid_exts)
    Lb = L.astype(jnp.uint8)
    if la <= 16:
        packed = Lb[:, 0::2] | (Lb[:, 1::2] << 4)
    else:
        packed = Lb
    return packed, O.astype(jnp.uint16)


@jax.jit
def gather_offsets(O16: jnp.ndarray, flat_idx: jnp.ndarray) -> jnp.ndarray:
    """Pick offsets at (padded) flat token-start indices of a (G, B) table."""
    return O16.reshape(-1)[flat_idx]


def unpack_lengths(packed: "np.ndarray", B: int, la: int) -> "np.ndarray":
    """Host-side inverse of the nibble packing in match_blocks_compact."""
    import numpy as np

    if la <= 16:
        L = np.empty(B, np.uint8)
        L[0::2] = packed & 0x0F
        L[1::2] = packed >> 4
        return L
    return packed


def encode_block(
    block: jnp.ndarray,
    halo: jnp.ndarray,
    right: jnp.ndarray,
    avail: jnp.ndarray,
    valid_ext: jnp.ndarray,
    entry: jnp.ndarray | int = 0,
    *,
    la: int,
    sb: int,
    matcher: str | None = None,
):
    """One block -> (off, len, next, count, exit_pos), padded to block size."""
    B = block.shape[0]
    find = match_ops.get_matcher(matcher, la)
    L, O = find(block, halo, right, avail, valid_ext, la=la, sb=sb)
    vl = jnp.minimum(valid_ext, B)
    starts, count, exit_pos = parse_ops.greedy_parse(L, vl, entry, la=la)
    block_ext = jnp.concatenate([block, right])
    off, ln, nxt = parse_ops.gather_tokens(
        starts, vl, L, O, block_ext, la=la
    )
    return off, ln, nxt, count, exit_pos


encode_block_jit = jax.jit(
    encode_block, static_argnames=("la", "sb", "matcher")
)
