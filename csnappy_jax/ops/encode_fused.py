"""Batched block encoder in plain jax.numpy, compiled by XLA.

Each block (fragment) of at most 32 KiB is compressed on its own, as the
reference's fragment loop does (csnappy_compress.c:621-656).  Every stage
is a dense array operation over the block's positions:

  1. match index: sort every position by its full 4-byte window (w, pos).
     Each position's sorted predecessor with an equal window is its most
     recent prior occurrence, exactly, with no hash table (the reference's
     lossy 2^16 table, csnappy_compress.c:501,535-551; any match source is
     conformant, :221-227).  The sort carries the windows at p+4 ..
     p+4*EXTRAS, so the match length against that predecessor (the vector
     FindMatchLength, :252-295) is an elementwise compare in sorted order.
  2. walk table: w[p] = STORE when p holds a match, plus the advance to the
     next position the greedy parse visits from p: the first match at or
     after p + ml[p] (the skip ahead of :535-551), or the first match
     after p when p holds none.
  3. walk: the greedy commits are the orbit of 0 under p -> p + advance[p],
     restricted to STORE positions, found by pointer doubling.
  4. emission: each commit, and a virtual one at the block end, is one
     record, a literal (the gap since the previous commit ended) then a
     copy (EmitLiteral/EmitCopy, :332-415).  Record sizes give output
     offsets by a cumsum; every output byte finds its record by a scatter
     and a cummax forward fill, and is valued from the record's fields or
     gathered from the input (literal payload).

Grammar guarantees: COPY_1 iff len<12 & offset<2048, no COPY_4, no
cross-block offsets, output <= 32 + n + n/6 (csnappy_compress.c:612-616).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..models import wire
from . import batching
from .decode_jnp import ceil_log2

NOCAND = 0x7FFF   # candidate sentinel
STORE = 1 << 30   # walk-table flag: the position holds a match
ADVANCE = 0x1FFFF  # walk-table field: distance to the next visited position
# Carried LCP windows (direct LCP cap = 4 + 4*EXTRAS).  Each carried sort
# operand costs sort time; the staircase propagation recovers most long
# matches, so EXTRAS=2 compresses urls.10K to 354,567 B (reference
# 357,267) where EXTRAS=7 reaches 344,271 B.  EXTRAS=1 misses the
# reference ratio (360,200 B), so 2 is the floor.
EXTRAS = 2


def _srl(x, k):
    return jax.lax.shift_right_logical(x, k)


def _match_index(data, blens):
    """Per position: (has, cand, ml) — whether p commits to a match, the
    match source and the match length (0 where has is false).

    data: int32[B, BS] byte values; blens: int32[B]."""
    B, BS = data.shape
    i32 = jnp.int32
    extz = jnp.concatenate([data, jnp.zeros((B, 32), i32)], axis=1)

    def win(at):
        return (
            extz[:, at : BS + at]
            | (extz[:, at + 1 : BS + at + 1] << 8)
            | (extz[:, at + 2 : BS + at + 2] << 16)
            | (extz[:, at + 3 : BS + at + 3] << 24)
        )

    w = win(0)
    posf = jnp.broadcast_to(jnp.arange(BS, dtype=i32)[None, :], (B, BS))
    # lexicographic (w, pos) keys: signed order still groups equal windows
    # and pos keeps each group ascending, so the sorted predecessor with an
    # equal window is the most recent prior occurrence
    carried = jax.lax.sort(
        (w, posf) + tuple(win(4 * k) for k in range(1, 1 + EXTRAS)),
        dimension=1, is_stable=False, num_keys=2,
    )
    ws, ps = carried[0], carried[1]
    same = jnp.concatenate(
        [jnp.zeros((B, 1), jnp.bool_), ws[:, 1:] == ws[:, :-1]], axis=1
    )
    scand = jnp.where(same, jnp.roll(ps, 1, axis=1), NOCAND)

    # LCP against the sorted predecessor over all carried windows at once
    st = jnp.stack(carried[2:], axis=1)                  # (B, EXTRAS, BS)
    xk = st ^ jnp.concatenate([st[:, :, :1], st[:, :, :-1]], axis=2)
    eqw = (xk == 0).astype(i32)
    teqk = jnp.where(
        xk == 0, 4,
        ((xk & 0xFF) == 0).astype(i32)
        + ((xk & 0xFFFF) == 0).astype(i32)
        + ((xk & 0xFFFFFF) == 0).astype(i32),
    )
    pref = jnp.concatenate(
        [jnp.ones((B, 1, BS), i32), jnp.cumprod(eqw[:, :-1, :], axis=1)],
        axis=1,
    )
    lcp = 4 + jnp.sum(pref * teqk, axis=1)
    slcp = jnp.where(same, lcp, 0)
    # un-sort by pos (unique) with cand (15 bits) and lcp (6 bits, <=
    # 4+4*EXTRAS) packed into one carried operand
    _, upk = jax.lax.sort(
        (ps, scand | (slcp << 15)), dimension=1, is_stable=False, num_keys=1
    )
    cand = upk & 0x7FFF
    lcpu = _srl(upk, 15) & 0x3F
    blc = blens[:, None]
    has = (cand != NOCAND) & (posf + 4 <= blc) & (cand < posf)
    # staircase propagation: when cand[p+1] == cand[p] + 1 the exact 4-byte
    # match at p extends through p+1's match, so ml(p) >= 1 + ml(p+1);
    # inductively ml(p) >= (j - p) + lcp(j) for every j in p's run of
    # consecutive candidates.  Computed as a reverse cummax of
    # h(j) = j + lcp(j), segmented by run id (later runs are offset by K,
    # more than any in-block h difference, so they never win across a break).
    candn = jnp.concatenate([cand[:, 1:], jnp.full((B, 1), NOCAND, i32)], axis=1)
    hasn = jnp.concatenate([has[:, 1:], jnp.zeros((B, 1), jnp.bool_)], axis=1)
    consec = has & hasn & (candn == cand + 1)
    # K must exceed any in-block h difference (BS + max lcp < 2^16) and
    # keep rid*K inside int32 (rid < BS = 2^15, so K = 2^16 is the max)
    K = 1 << 16
    rid = jnp.cumsum((~consec).astype(i32), axis=1) - (~consec).astype(i32)
    hstair = jnp.where(has, posf + lcpu, 0) - rid * K
    segmax = jax.lax.cummax(hstair, axis=1, reverse=True) + rid * K
    cap = jnp.clip(blc - posf, 0, wire.MAX_COPY_LEN)
    ml0 = jnp.minimum(jnp.maximum(segmax - posf, lcpu), cap)
    # lazy deferral: the reference commits the first 4-byte match
    # (csnappy_compress.c:574-594), but any commit schedule is conformant
    # (:221-227).  Deferring one position costs <= 1 literal byte and pays
    # when the next position's match is >= 2 longer; a chain of deferrals
    # needs ml to grow by >= 2 a step, so no runaway literal can form.
    mln = jnp.concatenate([ml0[:, 1:], jnp.zeros((B, 1), i32)], axis=1)
    defer = has & hasn & (mln >= ml0 + 2)
    has = has & ~defer
    return has, cand, jnp.where(has, ml0, 0)


def walk_table(has, ml):
    """Greedy-parse entry table, int32[B, BS]: STORE where p holds a match,
    plus the distance (>= 1) to the next position the parse visits."""
    B, BS = has.shape
    pos = jnp.arange(BS, dtype=jnp.int32)
    # first match at or after p (BS when none), with BS itself appended
    nextm = jax.lax.cummin(jnp.where(has, pos, BS), axis=1, reverse=True)
    nextm = jnp.concatenate([nextm, jnp.full((B, 1), BS, jnp.int32)], axis=1)
    after_copy = jnp.take_along_axis(nextm, pos + ml, axis=1)
    nxt = jnp.where(has, after_copy, nextm[:, :BS])
    return jnp.where(has, STORE, 0) | (nxt - pos)


def _walk(wtab):
    """Commit flags of one block: the positions on the orbit of 0 under
    p -> p + advance[p] whose STORE bit is set (pointer doubling, like
    decode_jnp's tag chain)."""
    BS = wtab.shape[0]
    pos = jnp.arange(BS, dtype=jnp.int32)
    # node BS is the end: a self-loop
    jump = jnp.concatenate([pos + (wtab & ADVANCE), jnp.array([BS], jnp.int32)])
    seen = jnp.zeros((BS + 1,), jnp.int32).at[0].set(1)

    def body(_, carry):
        seen, jump = carry
        return seen.at[jump].max(seen), jump[jump]

    seen, _ = jax.lax.fori_loop(0, ceil_log2(BS + 1) + 1, body, (seen, jump))
    return (seen[:BS] > 0) & ((wtab & STORE) != 0)


def _emit(data, blen, commit, cand, ml):
    """Tag stream of one block: (uint8[max_compressed_length(BS)], length)."""
    BS = data.shape[0]
    ocap = wire.max_compressed_length(BS)
    i32 = jnp.int32
    z1 = jnp.zeros((1,), i32)
    pos = jnp.arange(BS + 1, dtype=i32)
    commit = jnp.concatenate([commit, jnp.zeros((1,), jnp.bool_)])
    ml = jnp.where(commit, jnp.concatenate([ml, z1]), 0)
    off = pos - jnp.concatenate([cand, z1])
    # one record per commit, plus the trailing literal at blen
    # (csnappy_compress.c:600-605)
    rec = commit | (pos == blen)
    prev_end = jnp.concatenate([z1, jax.lax.cummax(jnp.where(commit, pos + ml, 0))[:-1]])
    lit = jnp.where(rec, pos - prev_end, 0)
    rl = jnp.maximum(lit - 1, 0)
    ext = jnp.where(rl < wire.LITERAL_INLINE_MAX, 0, jnp.where(rl < 256, 1, 2))
    lit_size = jnp.where(lit > 0, 1 + ext + lit, 0)
    c1 = (ml <= wire.COPY1_MAX_LEN) & (off < wire.COPY1_MAX_OFFSET)
    size = lit_size + jnp.where(ml > 0, jnp.where(c1, 2, 3), 0)
    ends = jnp.cumsum(size)
    start = ends - size
    comp_len = ends[-1]

    # covering record of every output byte: its position, scattered at the
    # record's first byte and filled forward
    o = jnp.arange(ocap, dtype=i32)
    first = jnp.full((ocap,), -1, i32).at[jnp.where(size > 0, start, ocap)].max(
        pos, mode="drop"
    )
    p = jnp.clip(jax.lax.cummax(first), 0, BS)
    fields = jnp.stack([start, lit_size, rl, ext, prev_end, ml, off, c1.astype(i32)], axis=1)
    start, lit_size, rl, ext, src, ml, off, c1 = jnp.unstack(fields[p], axis=1)

    d = o - start
    lit_tag = jnp.where(rl < wire.LITERAL_INLINE_MAX, rl << 2,
                        (wire.LITERAL_INLINE_MAX - 1 + ext) << 2)
    trailer = _srl(rl, 8 * jnp.clip(d - 1, 0, 3)) & 0xFF
    payload = data[jnp.clip(src + d - 1 - ext, 0, BS - 1)]
    lit_val = jnp.where(d == 0, lit_tag, jnp.where(d <= ext, trailer, payload))
    dc = d - lit_size
    copy1 = jnp.where(
        dc == 0,
        wire.TAG_COPY_1 | ((ml - wire.MIN_MATCH) << 2) | (_srl(off, 8) << 5),
        off & 0xFF,
    )
    copy2 = jnp.where(
        dc == 0,
        wire.TAG_COPY_2 | ((ml - 1) << 2),
        jnp.where(dc == 1, off & 0xFF, _srl(off, 8) & 0xFF),
    )
    val = jnp.where(d < lit_size, lit_val, jnp.where(c1 > 0, copy1, copy2))
    return jnp.where(o < comp_len, val, 0).astype(jnp.uint8), comp_len


def encode_core(data, blens):
    """Compress a batch of blocks: data uint8[B, BS] (BS <= 32768),
    blens int32[B] -> (comp uint8[B, max_compressed_length(BS)], int32[B])."""
    data = data.astype(jnp.int32)
    has, cand, ml = _match_index(data, blens)
    commit = jax.vmap(_walk)(walk_table(has, ml))
    return jax.vmap(_emit)(data, blens, commit, cand, ml)


_encode = jax.jit(encode_core)


def block_width(bs: int) -> int:
    """Compiled block width for blocks of up to ``bs`` bytes: a power of two
    from 1 KiB to 32 KiB, so fragment sizes share a few programs."""
    if bs > wire.BLOCK_SIZE:
        raise ValueError(f"block of {bs} bytes exceeds {wire.BLOCK_SIZE}")
    return batching.bucket_pow2(max(bs, 1), 1024)


def encode_blocks(data: np.ndarray, blens: np.ndarray):
    """Compress B independent blocks.

    data: uint8[B, bs] zero-padded, bs <= 32768; blens: int[B].
    Returns (comp uint8[B, ocap], comp_lens int32[B]).
    """
    B, bs = data.shape
    BS = block_width(bs)
    ocap = wire.max_compressed_length(BS)
    pending = []
    for start, stop, padded in batching.dispatches(B, BS + ocap):
        chunk = np.zeros((padded, BS), np.uint8)
        chunk[: stop - start, :bs] = data[start:stop]
        lens = np.zeros((padded,), np.int32)
        lens[: stop - start] = blens[start:stop]
        pending.append((stop - start, _encode(chunk, lens)))
    comp = np.zeros((B, ocap), np.uint8)
    clens = np.zeros((B,), np.int32)
    at = 0
    for n, (c, cl) in pending:
        comp[at : at + n] = np.asarray(c)[:n]
        clens[at : at + n] = np.asarray(cl)[:n]
        at += n
    return comp, clens


def compress_np(data: bytes | np.ndarray, block_size: int = wire.BLOCK_SIZE) -> bytes:
    """Whole-stream compress: varint preamble + independent fragments
    (csnappy_compress.c:621-656 semantics), batched on device."""
    buf = np.frombuffer(data, np.uint8) if isinstance(data, (bytes, bytearray)) else data
    n = len(buf)
    out = bytearray(wire.varint_encode(n))
    if n == 0:
        return bytes(out)
    BS = block_size
    nb = (n + BS - 1) // BS
    padded = np.zeros((nb, BS), np.uint8)
    padded.reshape(-1)[:n] = buf
    blens = np.full((nb,), BS, np.int32)
    blens[-1] = n - (nb - 1) * BS
    comp, lens = encode_blocks(padded, blens)
    out += compact(comp, lens)
    return bytes(out)


def compact(comp: np.ndarray, lens: np.ndarray) -> bytes:
    """Concatenate comp[i, :lens[i]]: the native memcpy compactor when the
    host library is built (csrc), a Python join otherwise."""
    from ..runtime import native

    if native.available():
        return native.compact(comp, lens)
    return b"".join(comp[i, : lens[i]].tobytes() for i in range(len(lens)))
