"""Public codec API — parity surface for the reference's ``csnappy.h``.

Six entry points with the same contracts (csnappy.h:30-119), plus a backend
switch.  Errors are raised as :class:`SnappyError` carrying the reference's
numeric codes, or returned as codes by the ``*_status`` variants.

Backends:
  * ``"jax"``  — batched XLA programs on the default JAX device.
  * ``"py"``   — the pure-Python format model (oracle, slow).
  * ``"native"`` — the C++ host runtime, when built (csrc/).

Divergence note: header-mode :func:`decompress` additionally verifies the
stream produced exactly the header-declared length and raises
E_DATA_MALFORMED for a short stream (the reference's C lacks a
produced-length out-param and cannot check this at all).  The reference
Python model's even stricter E_INPUT_NOT_CONSUMED taxonomy — output exactly
full while input tags remain (pysnappy_decompress.py:57-60) — is implemented
by the ``py`` model's header-mode decode (pymodel.decompress,
strict_consume); the device backends fold that case into E_OUTPUT_OVERRUN
exactly as the reference C would.
"""
from __future__ import annotations

import numpy as np

from .errors import (
    E_DATA_MALFORMED,
    E_HEADER_BAD,
    E_OK,
    E_OUTPUT_INSUF,
    SnappyError,
    raise_for_code,
)
from .config import DEFAULT, CodecConfig
from .models import pymodel, wire

DEFAULT_BACKEND = "jax"


def _cfg(config):
    return config if config is not None else DEFAULT


def max_compressed_length(source_len: int) -> int:
    """csnappy_max_compressed_length (csnappy_compress.c:612-616)."""
    return wire.max_compressed_length(source_len)


def get_uncompressed_length(src: bytes) -> tuple[int, int]:
    """csnappy_get_uncompressed_length: (length, header_bytes) or E_HEADER_BAD."""
    try:
        return wire.varint_decode(bytes(src[: wire.MAX_VARINT32_BYTES + 1]))
    except ValueError as e:
        raise SnappyError(E_HEADER_BAD, str(e)) from None


def compress_fragment(data: bytes, backend: str | None = None,
                      config: CodecConfig | None = None) -> bytes:
    """Headerless compression of one fragment ≤ 32 KiB (csnappy.h:46-52).

    The caller-supplied workmem of the C API is internal here (the match
    index lives on the device)."""
    cfg = _cfg(config)
    backend = backend or cfg.backend
    if len(data) > wire.BLOCK_SIZE:
        raise ValueError("fragment larger than 32 KiB")
    if backend == "py":
        return pymodel.compress_fragment(data)
    if backend == "native":
        from .runtime import native

        return native.compress_fragment(data)
    from .ops import encode_fused

    buf = np.frombuffer(data, np.uint8)[None, :]
    comp, lens = encode_fused.encode_blocks(buf, np.array([len(data)], np.int32))
    frag = comp[0, : lens[0]].tobytes()
    if cfg.debug_checks:
        assert pymodel.decompress_noheader(frag, len(data)) == data, "oracle mismatch"
    return frag


def compress(data: bytes, backend: str | None = None,
             config: CodecConfig | None = None) -> bytes:
    """Whole-stream compression: varint preamble + config.block_size
    fragments (csnappy_compress.c:621-656)."""
    cfg = _cfg(config)
    backend = backend or cfg.backend
    if backend == "py":
        return pymodel.compress(data)
    if backend == "native":
        from .runtime import native

        return native.compress(data)
    from .ops import encode_fused

    out = encode_fused.compress_np(data, cfg.block_size)
    if cfg.debug_checks:
        assert pymodel.decompress(out) == bytes(data), "oracle mismatch"
    return out


def _decompress_stream_routed(body: np.ndarray, dst_len: int) -> tuple[int, bytes]:
    """Whole-stream decode routing (dst_len > one block): one decision.

    A native one-pass tag-boundary scan (csnappy_host_scan_segments)
    validates the stream in sequential event order and classifies it:

      * rc < 0 — malformed or overrun: the exact error, with no device pass;
      * rc == 0 — segmentable, as every stream the reference's 32 KiB
        fragment loop emits (csnappy_compress.c:636-654): no tag straddles
        a 32 KiB output boundary and no copy reaches a prior segment, so the
        segments decode as one batch of independent blocks;
      * anything else (tags or copies that cross segments, offsets beyond
        32 KiB), or no native library: the whole stream in one decode,
        refused with E_TOO_LARGE past decode_jnp.MAX_WIDTH.
    """
    from .ops import decode_jnp
    from .runtime import native

    rc = None
    if native.available():
        rc, offs, produced = native.scan_segments(body, dst_len, wire.BLOCK_SIZE)
    if rc is not None and rc < 0:
        return rc, b""
    if rc != 0:
        out, _, status = decode_jnp.decompress_noheader_np(body, dst_len)
        return status, out.tobytes()
    if len(offs) == 0:
        return E_OK, b""
    ends = np.append(offs[1:], len(body))
    flens = ends - offs
    segs = np.zeros((len(offs), int(flens.max())), np.uint8)
    for i, (a, n) in enumerate(zip(offs, flens)):
        segs[i, :n] = body[a : a + n]
    out, prod, status = decode_jnp.decode_blocks(segs, flens, wire.BLOCK_SIZE)
    bad = status[status != E_OK]
    if bad.size:
        return int(bad[0]), b""
    return E_OK, native.compact(out, prod)


def decompress_noheader(src: bytes, dst_len: int, backend: str | None = None,
                        config: CodecConfig | None = None) -> bytes:
    """Safe headerless decode into at most ``dst_len`` bytes (csnappy.h:107-119)."""
    cfg = _cfg(config)
    backend = backend or cfg.backend
    if backend == "py":
        return pymodel.decompress_noheader(src, dst_len)
    if backend == "native":
        from .runtime import native

        return native.decompress_noheader(src, dst_len)
    body = np.frombuffer(src, np.uint8)
    if dst_len <= wire.BLOCK_SIZE:
        from .ops import decode_jnp

        out, _, st = decode_jnp.decompress_noheader_np(body, dst_len)
        res = out.tobytes()
    else:
        st, res = _decompress_stream_routed(body, dst_len)
    raise_for_code(st)
    if cfg.debug_checks:
        assert pymodel.decompress_noheader(src, dst_len) == res, "oracle mismatch"
    return res


def decompress(src: bytes, dst_len: int | None = None, backend: str | None = None,
               config: CodecConfig | None = None) -> bytes:
    """Whole-stream decode with header parse + DoS length guard
    (csnappy_decompress.c:394-411)."""
    ulen, hdr = get_uncompressed_length(src)
    # Allocation DoS guard (ADVICE r1): a hostile 5-byte header can claim up
    # to 2^32-1 bytes.  No valid stream expands beyond 64 output bytes per
    # 3 compressed bytes (a COPY_2 len-64 tag), so a header beyond that
    # bound is unreachable — reject before sizing any buffer.
    body_len = len(src) - hdr
    if ulen > (body_len // 3 + 1) * 64:
        raise SnappyError(E_HEADER_BAD, f"header length {ulen} impossible for {body_len}-byte stream")
    if dst_len is None:
        dst_len = ulen
    if ulen > dst_len:
        raise SnappyError(E_OUTPUT_INSUF, f"header says {ulen}, buffer {dst_len}")
    out = decompress_noheader(src[hdr:], ulen, backend=backend, config=config)
    if len(out) != ulen:
        raise SnappyError(E_DATA_MALFORMED, f"produced {len(out)}, header said {ulen}")
    return out
