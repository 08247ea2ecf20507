"""Dispatch sizing shared by the batched device codecs.

A host batch of B blocks is cut into dispatches of at most
``blocks_per_dispatch(width)`` blocks, so that one dispatch's working set
stays bounded whatever B is (a 256 MiB page store is 65,536 pages of
4 KiB).  Each dispatch's batch is padded up to a power of two, so a sweep
over many batch sizes compiles O(log B) programs, not one per size.
"""
from __future__ import annotations

# Host bytes (compressed width + output width, per block) moved by one
# dispatch.  The device working set is a few dozen int32 arrays of that
# width, so 64 MiB keeps a dispatch to a few GiB of device memory.
DISPATCH_BYTES = 64 << 20


def bucket_pow2(n: int, base: int = 1) -> int:
    """Round ``n`` up to base·2^k."""
    b = base
    while b < n:
        b *= 2
    return b


def blocks_per_dispatch(width: int) -> int:
    """Largest power of two of blocks whose ``width`` bytes each fit the
    dispatch budget (at least one block)."""
    n = 1
    while 2 * n * width <= DISPATCH_BYTES:
        n *= 2
    return n


def dispatches(n_blocks: int, width: int, devices: int = 1) -> list[tuple[int, int, int]]:
    """Cut ``n_blocks`` blocks into dispatches: (start, stop, padded) triples
    where ``padded >= stop - start`` is the batch the dispatch is compiled
    for, a multiple of ``devices`` (one equal shard per device)."""
    cap = blocks_per_dispatch(width) * devices
    out = []
    for start in range(0, n_blocks, cap):
        stop = min(start + cap, n_blocks)
        per_device = -(-(stop - start) // devices)
        out.append((start, stop, devices * bucket_pow2(per_device)))
    return out
