"""lz77_tpu — an LZ77 codec framework on JAX devices.

A from-scratch JAX/XLA re-design of the capabilities of the C reference
codec (cstdvd/lz77): same stream format, CLI surface, and decode semantics,
but block-parallel and mesh-shardable instead of byte-serial.

Layering (mirrors SURVEY.md §1's layer map, re-drawn device-first):

* ``spec`` / ``bitio``      — format contract + host bitstream codec
* ``ops``                   — device kernels: match, parse, pack, decode
* ``models``                — codec pipelines (encoder, decoder, file codec)
* ``parallel``              — mesh / shard_map / multi-host orchestration
* ``utils``                 — metrics, profiling, manifest, fault handling
* ``cli``                   — reference-compatible command line driver
"""

from . import spec
from .spec import Params

__version__ = "0.1.0"


def compress(
    data: bytes,
    la: int = spec.DEFAULT_LA_SIZE,
    sb: int = spec.DEFAULT_SB_SIZE,
    *,
    backend: str = "auto",
    **kwargs,
) -> bytes:
    """One-call encode to a complete reference-format stream.

    ``backend``: "native" (parallel C++ host encoder), "jax" (device block
    pipeline; kwargs: block_size, batch_blocks, matcher), "numpy"
    (executable spec), or "auto" (native if built, else jax).  All backends
    emit byte-identical streams.
    """
    params = Params(la=la, sb=sb)
    if backend == "auto":
        from . import native as _native

        backend = "native" if _native.available() else "jax"
    if backend == "native":
        from . import native as _native

        return _native.encode(data, params, **kwargs)
    if backend == "numpy":
        from .models import spec_np

        return spec_np.encode(data, params)
    from .models import codec

    return codec.encode_bytes(data, params, **kwargs)


def decompress(data: bytes, *, backend: str = "auto") -> bytes:
    """One-call decode of a reference-format stream (self-describing)."""
    from .models import codec

    return codec.decode_bytes(data, backend=backend)


def compress_file(
    in_path: str,
    out_path: str,
    la: int = spec.DEFAULT_LA_SIZE,
    sb: int = spec.DEFAULT_SB_SIZE,
    *,
    pipeline: str = "host",
    **kwargs,
) -> None:
    """File-to-file encode in bounded memory (memmap input, streamed output).

    ``pipeline``: "host" (device match + host parse), "fused"
    (device-resident match+parse+pack), or "sharded" (multi-chip mesh);
    kwargs pass through to ``models.codec.encode_file`` (``manifest_path``/
    ``resume`` for checkpointing, ``block_size``, ``matcher``, ...).
    """
    from .models import codec

    codec.encode_file(
        in_path, out_path, Params(la=la, sb=sb), pipeline=pipeline, **kwargs
    )


def decompress_file(in_path: str, out_path: str, **kwargs) -> int:
    """File-to-file decode in O(window) memory (any stream size); returns
    the decoded byte count.  The reference's bounded-memory decode
    capability (lz77.c:148-197) via the native streamed decoder."""
    from .models import codec

    return codec.decode_file(in_path, out_path, **kwargs)


__all__ = [
    "spec", "Params", "compress", "decompress", "compress_file",
    "decompress_file", "__version__",
]
