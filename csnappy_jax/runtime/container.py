"""Paged block container — the reference's block_compressor capability (C8).

Container layout (block_compressor.c:298-333): ``u32 nr_pages`` then a
``u32[nr_pages]`` length table, then the concatenated per-page payloads.  The
length table doubles as the random-access index (SURVEY.md §5 "checkpoint /
resume" analog): any page can be located and decoded independently.

Rules mirrored from the reference:
  * raw fallback — a page whose compressed form is not smaller is stored
    uncompressed (block_compressor.c:315-324, 378-383).  A full raw page is
    identified by ``len == page_size`` exactly as in the reference; a raw
    *tail* page (shorter than page_size — a corner the reference leaves
    undefined) carries the ``RAW_BIT`` high bit on its length entry, since
    an incompressible 4093-4095-byte tail can compress to exactly
    page_size bytes and would otherwise be ambiguous (ADVICE r1).  Every
    stored *compressed* length is < ilen <= page_size, so the markers
    cannot collide with a compressed page.
  * per-page codec behind a vtable (struct compressor_funcs,
    block_compressor.c:233-249) — here "snappy" (device codec, batched) and
    "zlib" (stdlib, host); "lzo" is gated out when no binding exists.
  * codec-only timing and a compressibility histogram
    (block_compressor.c:251-268, 341-344).
"""
from __future__ import annotations

import struct
import time
import zlib
from dataclasses import dataclass, field

import numpy as np

from ..errors import E_DATA_MALFORMED, SnappyError
from ..ops import decode_jnp, encode_fused

RAW_BIT = 1 << 31  # length-table flag: raw tail page, true length in low bits


@dataclass
class BlockStats:
    """Reference's histogram + codec timing (block_compressor.c:341-344)."""

    nr_pages: int = 0
    bytes_in: int = 0
    bytes_out: int = 0
    codec_seconds: float = 0.0
    # buckets: expanded (>100%), >50%, <=50% — same three as the reference
    histogram: list[int] = field(default_factory=lambda: [0, 0, 0])

    def account(self, ilen: int, olen: int) -> None:
        self.nr_pages += 1
        self.bytes_in += ilen
        self.bytes_out += olen
        if olen >= ilen:
            self.histogram[0] += 1
        elif 2 * olen > ilen:
            self.histogram[1] += 1
        else:
            self.histogram[2] += 1


def compress_blocks(data: bytes, page_size: int = 4096, codec: str = "snappy") -> tuple[bytes, BlockStats]:
    """Compress ``data`` page-by-page into the container format."""
    stats = BlockStats()
    n = len(data)
    nr = (n + page_size - 1) // page_size
    head = bytearray(struct.pack("<I", nr))
    table = bytearray()
    payload = bytearray()

    if codec == "snappy":
        pages = np.zeros((max(nr, 1), page_size), np.uint8)
        flat = pages.reshape(-1)
        flat[:n] = np.frombuffer(data, np.uint8)
        lens = np.full((max(nr, 1),), page_size, np.int32)
        if nr:
            lens[-1] = n - (nr - 1) * page_size
        t0 = time.perf_counter()
        comp, clens = encode_fused.encode_blocks(pages, lens)
        stats.codec_seconds += time.perf_counter() - t0
        for i in range(nr):
            ilen, olen = int(lens[i]), int(clens[i])
            stats.account(ilen, olen)
            if olen >= ilen:  # raw fallback (block_compressor.c:315-324)
                marker = page_size if ilen == page_size else (RAW_BIT | ilen)
                table += struct.pack("<I", marker)
                payload += data[i * page_size : i * page_size + ilen]
            else:
                table += struct.pack("<I", olen)
                payload += comp[i, :olen].tobytes()
    elif codec == "zlib":
        for i in range(nr):
            page = data[i * page_size : (i + 1) * page_size]
            t0 = time.perf_counter()
            c = zlib.compress(page, 6)
            stats.codec_seconds += time.perf_counter() - t0
            stats.account(len(page), len(c))
            if len(c) >= len(page):
                marker = page_size if len(page) == page_size else (RAW_BIT | len(page))
                table += struct.pack("<I", marker)
                payload += page
            else:
                table += struct.pack("<I", len(c))
                payload += c
    else:
        if codec == "lzo":
            raise ValueError(
                "codec 'lzo' is gated out: no liblzo2/python-lzo binding in "
                "this environment (the reference's block_compressor.c:233-249 "
                "vtable has snappy|lzo|zlib; snappy and zlib are available)"
            )
        raise ValueError(f"unknown codec {codec!r} (available: snappy, zlib)")
    return bytes(head + table + payload), stats


def decompress_blocks(container: bytes, page_size: int = 4096, codec: str = "snappy") -> tuple[bytes, BlockStats]:
    """Inverse of :func:`compress_blocks` (block_compressor.c:348-394)."""
    stats = BlockStats()
    if len(container) < 4:
        raise SnappyError(E_DATA_MALFORMED, "container too short")
    (nr,) = struct.unpack_from("<I", container, 0)
    table_end = 4 + 4 * nr
    if len(container) < table_end:
        raise SnappyError(E_DATA_MALFORMED, "length table truncated")
    raw_lens = np.frombuffer(container, np.uint32, count=nr, offset=4)
    raw_mask = (raw_lens == page_size) | (raw_lens & RAW_BIT > 0)
    lens = (raw_lens & ~np.uint32(RAW_BIT)).astype(np.int64)
    if (lens > page_size).any():
        raise SnappyError(E_DATA_MALFORMED, "length entry exceeds page size")
    offs = np.concatenate([[0], np.cumsum(lens)]) + table_end
    if offs[-1] > len(container):
        raise SnappyError(E_DATA_MALFORMED, "payload truncated")

    out = bytearray()
    if codec == "snappy":
        comp_idx = [i for i in range(nr) if not raw_mask[i]]
        if comp_idx:
            width = int(max(lens[i] for i in comp_idx))
            batch = np.zeros((len(comp_idx), width), np.uint8)
            blens = np.zeros((len(comp_idx),), np.int32)
            for j, i in enumerate(comp_idx):
                seg = container[offs[i] : offs[i] + lens[i]]
                batch[j, : len(seg)] = np.frombuffer(seg, np.uint8)
                blens[j] = lens[i]
            t0 = time.perf_counter()
            dec, produced, status = decode_jnp.decode_blocks(batch, blens, page_size)
            stats.codec_seconds += time.perf_counter() - t0
            bad = status[status != 0]
            if bad.size:
                raise SnappyError(int(bad[0]), "page decode failed")
        j = 0
        for i in range(nr):
            if raw_mask[i]:
                out += container[offs[i] : offs[i] + lens[i]]
                stats.account(int(lens[i]), int(lens[i]))
            else:
                out += dec[j, : produced[j]].tobytes()
                stats.account(int(produced[j]), int(lens[i]))
                j += 1
    elif codec == "zlib":
        for i in range(nr):
            seg = container[offs[i] : offs[i] + lens[i]]
            if raw_mask[i]:
                out += seg
            else:
                t0 = time.perf_counter()
                out += zlib.decompress(bytes(seg))
                stats.codec_seconds += time.perf_counter() - t0
    else:
        if codec == "lzo":
            raise ValueError(
                "codec 'lzo' is gated out: no liblzo2/python-lzo binding in "
                "this environment"
            )
        raise ValueError(f"unknown codec {codec!r}")
    return bytes(out), stats
