"""Snappy decoder in plain jax.numpy, compiled by XLA: the one device decoder.

It decodes every legal stream: batches of independent blocks, whole streams
whose tags and copies cross 32 KiB boundaries, and copy offsets beyond
32 KiB, as written by encoders with larger blocks.

The reference decoder (csnappy_decompress.c:319-387) is a strictly
sequential tag loop: tag N's byte position depends on every prior tag's
length, and overlapping back-references are resolved byte-at-a-time.  Here
both chains are broken with pointer doubling, turning the whole decode into
~2·log2(n) batched passes with no data-dependent control flow:

Phase A — tag-boundary resolution.  For *every* byte position ``p`` of the
compressed stream, compute speculatively (as if a tag started there) the tag's
advance, output contribution and fields.  This defines a successor function
``nxt[p]``; the real tag starts are the orbit of 0 under ``nxt``.  Reachability
is propagated with doubled jump pointers (scatter-max frontier), and per-tag
output offsets are a saturating prefix sum over the reached tags.

Phase B — output materialization.  Scatter tag ids at their output offsets and
forward-fill (cummax) to find the covering tag of every output byte; literal
bytes point straight into the input, copy bytes point ``offset`` back into the
output.  That parent function is again resolved by pointer doubling (every
chain strictly decreases), the parallel analog of the reference's
pattern-doubling IncrementalCopyFastPath (csnappy_decompress.c:240-254).

Safety contract is the reference's: offset==0 / offset>written / truncated
tags ⇒ E_DATA_MALFORMED; output beyond ``dst_limit`` ⇒ E_OUTPUT_OVERRUN, with
the sequential priority of the reference's loop; no index ever goes out of
bounds regardless of input bytes (all gathers and scatters are clamped or
dropped).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..errors import E_DATA_MALFORMED, E_OK, E_OUTPUT_OVERRUN, E_TOO_LARGE, SnappyError
from ..models import wire
from . import batching

NO_EVENT = np.iinfo(np.int32).max
# Output positions saturate here: above any dst_limit and any out_cap.
SATURATE = NO_EVENT
# Widest compressed or output width (after bucketing) one decode takes.
# Positions are int32, which sets this bound: device memory does not (the
# peak is about 10.5 B per width byte on the H100, 18.4 GB at this width).
MAX_WIDTH = 1 << 30


def ceil_log2(n: int) -> int:
    return max(1, int(n - 1).bit_length())


def _parse_all_positions(comp: jnp.ndarray, src_len: jnp.ndarray, out_cap: int):
    """Speculative per-position tag parse (vectorized, branch-free).

    Returns dict of per-position arrays: successor, produced output length,
    tag fields and validity.  ``comp`` is int32[P] with values 0..255.
    """
    P = comp.shape[0]
    ext = jnp.concatenate([comp, jnp.zeros((4,), jnp.int32)])
    b0 = comp
    b1, b2, b3, b4 = (jax.lax.dynamic_slice_in_dim(ext, k, P) for k in range(1, 5))

    kind = b0 & 3
    u = b0 >> 2
    is_lit = kind == wire.TAG_LITERAL

    # literal length: inline (u<60) or 1-4 LE trailer bytes holding len-1
    extra = jnp.clip(u - 59, 0, 4)
    le4 = (
        b1.astype(jnp.uint32)
        | (b2.astype(jnp.uint32) << 8)
        | (b3.astype(jnp.uint32) << 16)
        | (b4.astype(jnp.uint32) << 24)
    )
    shift = (8 * (4 - jnp.maximum(extra, 1))).astype(jnp.uint32)
    trailer_val = jnp.where(extra > 0, (le4 << shift) >> shift, jnp.uint32(0))
    lit_len_u = trailer_val + 1  # uint32; wraps to 0 iff trailer was 0xFFFFFFFF
    lit_too_big = (u >= 60) & ((lit_len_u == 0) | (lit_len_u > jnp.uint32(P)))
    lit_len = jnp.where(
        u >= 60,
        jnp.minimum(lit_len_u, jnp.uint32(P)).astype(jnp.int32),
        u + 1,
    )

    hdr = jnp.where(
        is_lit,
        1 + extra,
        jnp.where(kind == wire.TAG_COPY_1, 2, jnp.where(kind == wire.TAG_COPY_2, 3, 5)),
    )
    copy_len = jnp.where(kind == wire.TAG_COPY_1, (u & 7) + wire.MIN_MATCH, u + 1)
    # copy4 offsets >= 2^31 come out negative in int32 — caught by the
    # offset-validity check (offset <= 0 => malformed)
    copy_off = jnp.where(
        kind == wire.TAG_COPY_1,
        ((u >> 3) << 8) | b1,
        jnp.where(kind == wire.TAG_COPY_2, b1 | (b2 << 8), b1 | (b2 << 8) | (b3 << 16) | (b4 << 24)),
    )

    produced = jnp.where(is_lit, lit_len, copy_len)
    advance = hdr + jnp.where(is_lit, lit_len, 0)

    pos = jnp.arange(P, dtype=jnp.int32)
    in_range = pos < src_len
    # compared as a difference: pos + advance can pass 2^31 at MAX_WIDTH
    tag_err = in_range & ((advance > src_len - pos) | (is_lit & lit_too_big))
    usable = in_range & ~tag_err
    nxt = jnp.where(usable, pos + advance, P)
    produced = jnp.where(usable, jnp.minimum(produced, out_cap + 1), 0)

    return dict(
        pos=pos,
        kind=kind,
        nxt=nxt,
        produced=produced,
        copy_off=copy_off,
        lit_src=pos + hdr,  # literal payload starts right after the header
        tag_err=tag_err,
        in_range=in_range,
    )


def _saturating_prefix(x: jnp.ndarray, cap: int = SATURATE):
    """(exclusive prefix sums, total) of non-negative int32 ``x``, each
    clamped at ``cap`` so no sum wraps: exact wherever the true sum is below
    ``cap``, and ``cap`` where it is not."""
    u = x.astype(jnp.uint32)
    incl = jax.lax.associative_scan(lambda a, b: jnp.minimum(a + b, jnp.uint32(cap)), u)
    excl = jnp.concatenate([jnp.zeros((1,), jnp.uint32), incl[:-1]])
    return excl.astype(jnp.int32), incl[-1].astype(jnp.int32)


def _resolve_tag_chain(nxt: jnp.ndarray, produced: jnp.ndarray):
    """Pointer-doubling over the tag successor graph.

    Returns (is_tag[P] reached-from-0 mask, out_start[P], total_out scalar).
    Output positions saturate at SATURATE (beyond any dst_limit), so a
    stream claiming more than 2^31 output bytes is an overrun, never a
    wrapped sum.
    """
    P = nxt.shape[0]
    # sentinel node P: self-loop
    J = jnp.concatenate([nxt, jnp.array([P], jnp.int32)])
    m = jnp.zeros((P + 1,), jnp.int32).at[0].set(1)

    def body(_, carry):
        m, J = carry
        m = m.at[J].max(m, mode="drop")
        return m, J[J]

    m, _ = jax.lax.fori_loop(0, ceil_log2(P + 1) + 1, body, (m, J))
    is_tag = m[:P].astype(bool)
    # tags lie in position order, so a tag's output start is the sum of the
    # output of the tags before it
    out_start, total_out = _saturating_prefix(jnp.where(is_tag, produced, 0))
    return is_tag, out_start, total_out


def _materialize(comp, tags, is_tag, out_start, total_out, out_cap: int):
    """Phase B: the output bytes (0 past ``total_out``)."""
    P = comp.shape[0]
    # covering tag for every output byte: scatter tag id at its output start,
    # then forward-fill.  Output starts are strictly increasing over real tags
    # (every tag produces >= 1 byte), so ids never collide.
    scat_idx = jnp.where(is_tag & (out_start >= 0) & (out_start < out_cap), out_start, out_cap)
    cover = (
        jnp.full((out_cap + 1,), -1, jnp.int32)
        .at[scat_idx]
        .max(jnp.where(is_tag, tags["pos"], -1), mode="drop")[:out_cap]
    )
    cover = jax.lax.cummax(cover)
    cp = jnp.clip(cover, 0, P - 1)

    t_kind = tags["kind"][cp]
    t_os = out_start[cp]
    t_off = tags["copy_off"][cp]
    t_lit_src = tags["lit_src"][cp]

    o = jnp.arange(out_cap, dtype=jnp.int32)
    live = (o < total_out) & (cover >= 0)
    is_copy_byte = live & (t_kind != wire.TAG_LITERAL)
    # a bad offset is reported by the status; its bytes are clamped in range
    parent = jnp.clip(jnp.where(is_copy_byte, o - t_off, o), 0, out_cap - 1)

    def body(_, par):
        return par[par]

    parent = jax.lax.fori_loop(0, ceil_log2(out_cap) + 1, body, parent)

    # parent now points at a literal byte; fetch its input position, then value
    root_src = jnp.clip(t_lit_src + (o - t_os), 0, P - 1)  # per literal byte
    src_idx = root_src[parent]
    return jnp.where(live, comp[src_idx], 0)


def _decode_core(comp, src_len, dst_limit, out_cap: int):
    """comp: uint8[P], src_len/dst_limit: int32 scalars.

    Returns (out uint8[out_cap], produced int32, status int32).
    """
    comp = comp.astype(jnp.int32)
    tags = _parse_all_positions(comp, src_len, out_cap)
    is_tag, out_start, total_out = _resolve_tag_chain(tags["nxt"], tags["produced"])
    out = _materialize(comp, tags, is_tag, out_start, total_out, out_cap)

    # Sequential error priority (csnappy_decompress.c:319-387): the first
    # malformed tag in stream order is charged at its output start — a
    # truncated or oversized tag, or a copy whose offset is 0 or beyond the
    # bytes written so far (a truncated tag ends the chain, so its output
    # start is also where an unterminated stream stops).  The overrun is
    # charged at dst_limit.  The earlier event wins; on a tie the malformed
    # one does, because the reference checks the offset (and the input)
    # before the space (SAW__AppendFromSelf, csnappy_decompress.c:295-317).
    copy_off = tags["copy_off"]
    bad_copy = (tags["kind"] != wire.TAG_LITERAL) & ((copy_off <= 0) | (copy_off > out_start))
    bad = is_tag & tags["in_range"] & (tags["tag_err"] | bad_copy)
    malformed_at = jnp.min(jnp.where(bad, out_start, NO_EVENT))
    overrun = total_out > dst_limit
    malformed = (malformed_at != NO_EVENT) & (~overrun | (malformed_at <= dst_limit))
    status = jnp.where(malformed, E_DATA_MALFORMED, jnp.where(overrun, E_OUTPUT_OVERRUN, E_OK))
    produced = jnp.where(status == E_OK, total_out, 0)
    return out.astype(jnp.uint8), produced, status


@functools.partial(jax.jit, static_argnames="out_cap")
def decode_batch(comp, src_lens, dst_limits, out_cap: int):
    """Decode a batch of headerless tag streams: comp uint8[B, P],
    src_lens/dst_limits int32[B] -> (out uint8[B, out_cap], produced, status)."""
    core = functools.partial(_decode_core, out_cap=out_cap)
    return jax.vmap(core)(comp, src_lens, dst_limits)


# --------------------------------------------------------------------------
# host-facing wrappers with shape bucketing


def bucket(n: int, quantum: int = 4096) -> int:
    """Round up to limit recompiles: powers of two with two mid-points."""
    n = max(n, quantum)
    p = 1 << (n - 1).bit_length()
    for cand in (p // 2, p * 5 // 8, p * 3 // 4, p):
        if cand >= n and cand % quantum == 0:
            return cand
    return p


def decode_blocks(comp: np.ndarray, src_lens: np.ndarray, dst_limits) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batched headerless decode of independent blocks.

    comp: uint8[B, P]; src_lens: int[B]; dst_limits: int, or int[B] — the
    most each block may produce.  Returns (out uint8[B, out_cap], produced
    int32[B], status int32[B]) where out_cap >= max(dst_limits); status uses
    the CSNAPPY error codes, and a block that failed produced 0 bytes.
    Raises E_TOO_LARGE, before allocating, when either width exceeds
    MAX_WIDTH.
    """
    B, P = comp.shape
    limits = np.broadcast_to(np.asarray(dst_limits, np.int64), (B,))
    Pb = bucket(P)
    out_cap = bucket(int(limits.max()) if B else 0)
    if max(Pb, out_cap) > MAX_WIDTH:
        raise SnappyError(E_TOO_LARGE, f"widths {Pb} in, {out_cap} out; at most {MAX_WIDTH}")
    pending = []
    for start, stop, padded in batching.dispatches(B, Pb + out_cap):
        n = stop - start
        chunk = np.zeros((padded, Pb), np.uint8)
        chunk[:n, :P] = comp[start:stop]
        lens = np.zeros((padded,), np.int32)
        lens[:n] = src_lens[start:stop]
        lims = np.zeros((padded,), np.int32)
        lims[:n] = limits[start:stop]
        pending.append((n, decode_batch(chunk, lens, lims, out_cap=out_cap)))
    out = np.zeros((B, out_cap), np.uint8)
    produced = np.zeros((B,), np.int32)
    status = np.zeros((B,), np.int32)
    at = 0
    for n, (o, pr, st) in pending:
        out[at : at + n] = np.asarray(o)[:n]
        produced[at : at + n] = np.asarray(pr)[:n]
        status[at : at + n] = np.asarray(st)[:n]
        at += n
    return out, produced, status


def decompress_noheader_np(src: np.ndarray, dst_len: int) -> tuple[np.ndarray, int, int]:
    """Decode one headerless tag stream (uint8 array) on the default device.

    Returns (out uint8[produced], produced, status) — status uses the
    CSNAPPY error codes; on error ``out`` is empty.
    """
    src = np.asarray(src, np.uint8)
    out, produced, status = decode_blocks(src[None, :], np.array([len(src)]), dst_len)
    return out[0, : produced[0]], int(produced[0]), int(status[0])
