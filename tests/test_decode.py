"""The device decoder through every entry point, against the Python model.

Entry points: a batch of blocks (``decode_jnp.decode_blocks``, the fragment
sharing its batch with other rows), one whole stream
(``decode_jnp.decompress_noheader_np``), the public API (which routes whole
streams on the native tag scan, or decodes them whole without it), and the
page container.
"""
import struct
from unittest import mock

import numpy as np
import pytest

from csnappy_jax import api, errors
from csnappy_jax.models import pymodel, wire
from csnappy_jax.ops import batching, decode_jnp
from csnappy_jax.runtime import container, native

BLOCK_ENTRIES = ("blocks", "stream", "api", "container")
STREAM_ENTRIES = ("blocks", "stream", "api", "api_noscan")
NEIGHBOUR = pymodel.compress_fragment(b"neighbour row " * 9)


def decode_via(entry: str, frag: bytes, dst_len: int) -> tuple[int, bytes]:
    """(status, bytes) of decoding ``frag`` into at most ``dst_len`` bytes."""
    if entry == "blocks":
        rows = [NEIGHBOUR, frag, b""]
        arr = np.zeros((3, max(len(r) for r in rows)), np.uint8)
        for i, r in enumerate(rows):
            arr[i, : len(r)] = np.frombuffer(r, np.uint8)
        limits = np.array([len(b"neighbour row " * 9), dst_len, 0])
        out, produced, status = decode_jnp.decode_blocks(arr, np.array([len(r) for r in rows]), limits)
        assert status[0] == errors.E_OK and status[2] == errors.E_OK and produced[2] == 0
        assert out[0, : produced[0]].tobytes() == b"neighbour row " * 9
        return int(status[1]), out[1, : produced[1]].tobytes()
    if entry == "stream":
        out, _, status = decode_jnp.decompress_noheader_np(np.frombuffer(frag, np.uint8), dst_len)
        return status, out.tobytes()
    try:
        if entry == "api":
            return errors.E_OK, api.decompress_noheader(frag, dst_len)
        if entry == "api_noscan":
            with mock.patch.object(native, "available", return_value=False):
                return errors.E_OK, api.decompress_noheader(frag, dst_len)
        assert len(frag) < dst_len, "a page as long as the page is stored raw"
        cont = struct.pack("<II", 1, len(frag)) + frag
        return errors.E_OK, container.decompress_blocks(cont, page_size=dst_len)[0]
    except errors.SnappyError as e:
        return e.code, b""


def oracle(frag: bytes, dst_len: int) -> tuple[int, bytes]:
    try:
        return errors.E_OK, pymodel.decompress_noheader(frag, dst_len)
    except errors.SnappyError as e:
        return e.code, b""


def _entries(frag: bytes, dst_len: int):
    # the container stores a page that does not shrink as raw bytes
    return BLOCK_ENTRIES if len(frag) < dst_len else BLOCK_ENTRIES[:3]


def _cases(named):
    return [pytest.param(e, *args, id=f"{name}-{e}")
            for name, args in named for e in _entries(*args[:2])]


def _lit(payload: bytes) -> bytes:
    s = bytearray()
    wire.emit_literal(s, payload)
    return bytes(s)


def _copy1(length: int, offset: int) -> bytes:
    return bytes([wire.TAG_COPY_1 | ((length - wire.MIN_MATCH) << 2) | ((offset >> 8) << 5), offset & 0xFF])


def _copy2(length: int, offset: int) -> bytes:
    return bytes([wire.TAG_COPY_2 | ((length - 1) << 2)]) + offset.to_bytes(2, "little")


def _copy4(length: int, offset: int) -> bytes:
    return bytes([wire.TAG_COPY_4 | ((length - 1) << 2)]) + offset.to_bytes(4, "little")


_rng = np.random.default_rng(0)
_RAND4000 = _rng.integers(0, 256, 4000, dtype=np.uint8).tobytes()
_LONGLIT = _rng.integers(0, 256, 2000, dtype=np.uint8).tobytes() + b"abcdefgh" * 200
_RAND4196 = np.random.default_rng(12).integers(0, 256, 4196, dtype=np.uint8).tobytes()
_RAND1200 = np.random.default_rng(6).integers(0, 256, 1200, dtype=np.uint8).tobytes() + b"abcdefgh" * 100
_TWO_BYTE_TAGS = b"".join(b"\x00" + bytes([i & 0xFF]) for i in range(2048))

ROUNDTRIP = [
    ("empty", b""),
    ("one", b"a"),
    ("hello", b"hello world hello world hello"),
    ("rle", b"a" * 4096),                        # offset-1 overlapping copies
    ("ab", b"ab" * 2048),
    ("period256", bytes(range(256)) * 16),        # far matches
    ("fox", b"the quick brown fox jumps over the lazy dog " * 90),
    ("random", _RAND4000),                        # incompressible
    ("long_literal_then_copies", _LONGLIT),
    ("literal_1200_then_copies", _RAND1200),
]


@pytest.mark.parametrize(
    "entry,frag,dst_len,data",
    _cases([(n, (pymodel.compress_fragment(d), 4096, d)) for n, d in ROUNDTRIP]),
)
def test_roundtrip_4k(entry, frag, dst_len, data):
    assert decode_via(entry, frag, dst_len) == (errors.E_OK, data)


@pytest.mark.parametrize("entry", BLOCK_ENTRIES)
def test_roundtrip_32k_urls(entry, urls10k):
    data = urls10k[:32768]
    assert decode_via(entry, pymodel.compress_fragment(data), 32768) == (errors.E_OK, data)


@pytest.mark.parametrize("entry", BLOCK_ENTRIES)
def test_nonpow2_out_cap(entry):
    # a limit that is no power of two: the last bytes must still resolve
    frag = pymodel.compress_fragment(_RAND4196)
    if entry == "container":
        frag = pymodel.compress_fragment(_RAND4196[:4100])
        assert decode_via(entry, frag, 4196) == (errors.E_OK, _RAND4196[:4100])
    else:
        assert decode_via(entry, frag, 4196) == (errors.E_OK, _RAND4196)


@pytest.mark.parametrize("entry", BLOCK_ENTRIES)
def test_copy4_accepted(entry):
    lit = b"0123456789abcdef"
    assert decode_via(entry, _lit(lit) + _copy4(8, 16), 64) == (errors.E_OK, lit + lit[:8])


@pytest.mark.parametrize("entry", BLOCK_ENTRIES)
def test_exact_tag_count_two_byte_literals(entry):
    # 2048 two-byte literal tags, the last ending exactly at the input's end
    want = bytes(i & 0xFF for i in range(2048))
    got = decode_via(entry, _TWO_BYTE_TAGS, 2048 if entry != "container" else 8192)
    assert got == (errors.E_OK, want)


MALFORMED = [
    ("fake", b"\xc4foooooo"),                    # truncated literal (cl_tester)
    ("copy_offset_zero", b"\x00a\x01\x00"),
    ("copy2_truncated", b"\x00a\x0a\x08\x00"[:4]),
    ("copy_too_far", _lit(b"ab") + _copy2(4, 100)),
    ("copy4_negative", _lit(b"ab") + _copy4(4, 1 << 31)),
    ("literal_trailer_truncated", b"\xf0"),
]


@pytest.mark.parametrize(
    "entry,frag,dst_len", _cases([(n, (f, 4096)) for n, f in MALFORMED])
)
def test_malformed_rejected(entry, frag, dst_len):
    assert decode_via(entry, frag, dst_len) == (errors.E_DATA_MALFORMED, b"")


@pytest.mark.parametrize("entry", BLOCK_ENTRIES)
def test_baddata3_rejected(entry, baddata3):
    _, hdr = wire.varint_decode(baddata3)
    status, _ = decode_via(entry, baddata3[hdr:], 65536 if entry != "container" else 32768)
    assert status != errors.E_OK
    assert status == oracle(baddata3[hdr:], 65536 if entry != "container" else 32768)[0]


@pytest.mark.parametrize("entry", BLOCK_ENTRIES)
def test_overrun_rejected(entry):
    frag = pymodel.compress_fragment(b"x" * 5000)
    assert decode_via(entry, frag, 4096) == (errors.E_OUTPUT_OVERRUN, b"")


# The reference's sequential error priority (csnappy_decompress.c:319-387):
# the first failing tag decides, and within a tag the offset and the input
# are checked before the space.  (name, stream, dst_len, expected code)
_FULL = _lit(bytes(range(64))) * 64                   # exactly 4096 bytes
PRIORITY = [
    ("offset_before_space", _lit(b"ab") + _copy1(4, 50) + _lit(b"c" * 60), 4,
     errors.E_DATA_MALFORMED),
    ("overrun_before_truncated_end", pymodel.compress_fragment(b"y" * 5000)[:-1], 4096,
     errors.E_OUTPUT_OVERRUN),
    ("truncated_tag_at_limit", _lit(b"abcd") + b"\xf0", 4, errors.E_DATA_MALFORMED),
    ("bad_copy_at_limit", _lit(b"abcd") + _copy1(4, 10), 4, errors.E_DATA_MALFORMED),
    ("overrun_then_bad_copy", _lit(b"abcdefgh") + _copy1(4, 100), 4, errors.E_OUTPUT_OVERRUN),
    ("truncated_overlong_literal", bytes([9 << 2]) + b"abcde", 4, errors.E_DATA_MALFORMED),
    ("copy_overrun", _lit(b"ab") + _copy2(8, 2), 5, errors.E_OUTPUT_OVERRUN),
    ("full_buffer_then_bad_copy", _FULL + _copy2(4, 5000), 4096, errors.E_DATA_MALFORMED),
    ("full_buffer_then_good_copy", _FULL + _copy2(4, 64), 4096, errors.E_OUTPUT_OVERRUN),
    ("full_buffer_then_truncated_copy", _FULL + _copy2(4, 64)[:2], 4096,
     errors.E_DATA_MALFORMED),
    ("bad_copy_after_overrun_far", _FULL + _lit(b"z" * 100) + _copy4(4, 0), 4096,
     errors.E_OUTPUT_OVERRUN),
]


@pytest.mark.parametrize(
    "entry,frag,dst_len,code", _cases([(n, (f, d, c)) for n, f, d, c in PRIORITY])
)
def test_error_priority_matches_model(entry, frag, dst_len, code):
    assert oracle(frag, dst_len)[0] == code
    assert decode_via(entry, frag, dst_len) == (code, b"")


@pytest.mark.parametrize("entry", BLOCK_ENTRIES)
def test_fuzz_roundtrip_vs_oracle(entry):
    rng = np.random.default_rng(42)
    for trial in range(10):
        kind = trial % 3
        n = int(rng.integers(1, 4096))
        if kind == 0:
            data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        elif kind == 1:
            data = (b"abcdef" * (n // 6 + 1))[:n]
        else:
            pieces, left = [], n
            while left > 0:
                m = int(rng.integers(1, min(left, 200) + 1))
                pieces.append(
                    rng.integers(0, 256, m, dtype=np.uint8).tobytes()
                    if rng.random() < 0.5 else bytes([int(rng.integers(97, 99))]) * m
                )
                left -= m
            data = b"".join(pieces)[:n]
        frag = pymodel.compress_fragment(data)
        assert decode_via(entry, frag, 4096) == (errors.E_OK, data), trial


@pytest.mark.parametrize("entry", BLOCK_ENTRIES)
def test_fuzz_malformed_matches_oracle(entry):
    # decoded-or-rejected exactly as the model does, never out of bounds
    rng = np.random.default_rng(43)
    base = pymodel.compress_fragment(b"hello world " * 200)
    for _ in range(10):
        bad = bytearray(base)
        for _ in range(int(rng.integers(1, 6))):
            bad[int(rng.integers(0, len(bad)))] = int(rng.integers(0, 256))
        assert decode_via(entry, bytes(bad), 4096) == oracle(bytes(bad), 4096)


def test_batched_mixed_blocks(urls10k):
    blocks = [urls10k[i * 4096 : (i + 1) * 4096] for i in range(8)]
    frags = [pymodel.compress_fragment(b) for b in blocks]
    arr = np.zeros((8, max(len(f) for f in frags)), np.uint8)
    for i, f in enumerate(frags):
        arr[i, : len(f)] = np.frombuffer(f, np.uint8)
    out, produced, status = decode_jnp.decode_blocks(arr, np.array([len(f) for f in frags]), 4096)
    assert (status == errors.E_OK).all()
    for i, b in enumerate(blocks):
        assert produced[i] == len(b) and out[i, : len(b)].tobytes() == b


def test_batched_container_pages(urls10k):
    data = urls10k[: 8 * 4096 + 100]
    cont, stats = container.compress_blocks(data, page_size=4096)
    assert stats.nr_pages == 9
    assert container.decompress_blocks(cont, page_size=4096)[0] == data


def test_decode_blocks_across_dispatches(monkeypatch, urls10k):
    frags = [pymodel.compress_fragment(urls10k[i * 4096 : (i + 1) * 4096]) for i in range(9)]
    arr = np.zeros((9, max(len(f) for f in frags)), np.uint8)
    for i, f in enumerate(frags):
        arr[i, : len(f)] = np.frombuffer(f, np.uint8)
    lens = np.array([len(f) for f in frags])
    limits = np.full((9,), 4096)
    limits[4] = 100                                  # one row overruns
    width = decode_jnp.bucket(arr.shape[1]) + decode_jnp.bucket(4096)
    monkeypatch.setattr(batching, "DISPATCH_BYTES", 2 * width)
    assert len(batching.dispatches(9, width)) == 5
    out, produced, status = decode_jnp.decode_blocks(arr, lens, limits)
    assert status[4] == errors.E_OUTPUT_OVERRUN and produced[4] == 0
    for i in set(range(9)) - {4}:
        assert status[i] == errors.E_OK
        assert out[i, : produced[i]].tobytes() == urls10k[i * 4096 : (i + 1) * 4096]


def test_decode_blocks_empty_batch_and_buckets():
    out, produced, status = decode_jnp.decode_blocks(np.zeros((0, 10), np.uint8), np.zeros(0), 4096)
    assert out.shape == (0, 4096) and produced.shape == status.shape == (0,)
    assert decode_jnp.bucket(1) == 4096 and decode_jnp.bucket(4097) == 8192
    assert decode_jnp.bucket(38261) == 40960
    assert decode_jnp.bucket(702087) == 786432
    out, produced, status = decode_jnp.decode_blocks(np.zeros((1, 0), np.uint8), np.zeros(1), 0)
    assert (int(produced[0]), int(status[0])) == (0, errors.E_OK)


# ---- whole streams: segments, crossing tags and copies, far offsets ----


def _body(stream: bytes) -> tuple[bytes, int]:
    ulen, hdr = wire.varint_decode(stream)
    return stream[hdr:], ulen


def _straddling() -> tuple[bytes, int, bytes]:
    raw = np.random.default_rng(3).integers(0, 256, 50000, dtype=np.uint8).tobytes()
    return _lit(raw) + _copy2(64, 1000), 50064, raw + raw[-1000 : -1000 + 64]


def _far_offset() -> tuple[bytes, int, bytes]:
    # 64 KiB-block encoders write copies reaching past 32 KiB
    raw = np.random.default_rng(5).integers(0, 256, 40000, dtype=np.uint8).tobytes()
    return _lit(raw) + _copy2(64, 39000) + _copy4(32, 40010), 40096, (
        raw + raw[1000:1064] + (raw + raw[1000:1064])[54:86])


@pytest.mark.parametrize("entry", STREAM_ENTRIES)
def test_golden_reference_stream(entry, urls10k, urls10k_snappy):
    # the reference-encoded 702 KB stream, bit-exact (22 segments)
    body, ulen = _body(urls10k_snappy)
    assert decode_via(entry, body, ulen) == (errors.E_OK, urls10k)


@pytest.mark.parametrize("entry", STREAM_ENTRIES)
def test_multisegment_own_stream(entry, urls10k):
    big = urls10k[:150000]
    body, ulen = _body(pymodel.compress(big))
    assert decode_via(entry, body, ulen) == (errors.E_OK, big)


@pytest.mark.parametrize("entry", STREAM_ENTRIES)
def test_straddling_literal_and_copy(entry):
    body, ulen, want = _straddling()
    assert decode_via(entry, body, ulen) == (errors.E_OK, want)


@pytest.mark.parametrize("entry", STREAM_ENTRIES)
def test_far_offset_stream(entry):
    body, ulen, want = _far_offset()
    assert oracle(body, ulen) == (errors.E_OK, want)
    assert decode_via(entry, body, ulen) == (errors.E_OK, want)


@pytest.mark.parametrize("entry", STREAM_ENTRIES)
def test_stream_wider_than_one_decode_is_refused(entry, monkeypatch):
    # refused with its own code before the device sees it, not an OOM
    body, ulen, _ = _far_offset()
    monkeypatch.setattr(decode_jnp, "MAX_WIDTH", 32768)
    monkeypatch.setattr(decode_jnp, "decode_batch", mock.Mock(side_effect=AssertionError))
    try:
        got = decode_via(entry, body, ulen)[0]
    except errors.SnappyError as e:
        got = e.code
    assert got == errors.E_TOO_LARGE


def test_segmentable_stream_is_never_too_wide(monkeypatch, urls10k, urls10k_snappy):
    # the native scan splits it into 32 KiB blocks, each within any bound
    monkeypatch.setattr(decode_jnp, "MAX_WIDTH", 32768)
    assert api.decompress(urls10k_snappy) == urls10k


@pytest.mark.parametrize("entry", STREAM_ENTRIES)
def test_copy_across_segment_boundary(entry):
    data = (b"abcdefgh" * 5000)[:40000]
    body, ulen = _body(pymodel.compress(data))
    assert decode_via(entry, body, ulen) == (errors.E_OK, data)


@pytest.mark.parametrize("entry", STREAM_ENTRIES)
def test_giant_literal_decodes_bit_exact(entry):
    # one tag advancing past 64 KiB of input
    raw = np.random.default_rng(4).integers(0, 256, 100000, dtype=np.uint8).tobytes()
    assert decode_via(entry, _lit(raw), len(raw)) == (errors.E_OK, raw)


@pytest.mark.parametrize("entry", STREAM_ENTRIES)
def test_truncated_multisegment(entry, urls10k):
    body, ulen = _body(pymodel.compress(urls10k[:100000]))
    # a 1-byte cut always lands mid-tag
    assert decode_via(entry, body[:-1], ulen) == (errors.E_DATA_MALFORMED, b"")


@pytest.mark.parametrize("entry", STREAM_ENTRIES)
def test_overrun_multisegment(entry, urls10k):
    body, ulen = _body(pymodel.compress(urls10k[:100000]))
    assert decode_via(entry, body, ulen - 5000) == (errors.E_OUTPUT_OVERRUN, b"")


@pytest.mark.parametrize("entry", STREAM_ENTRIES)
def test_adversarial_stream(entry, baddata3):
    body, _ = _body(baddata3)
    status, _ = decode_via(entry, body, 1 << 20)
    assert status != errors.E_OK and status == oracle(body, 1 << 20)[0]


@pytest.mark.parametrize("entry", STREAM_ENTRIES)
def test_fuzz_multisegment_vs_oracle(entry):
    rng = np.random.default_rng(77)
    for trial in range(3):
        pieces, n = [], 0
        while n < 90000:
            kind = int(rng.integers(0, 3))
            m = int(rng.integers(500, 8000))
            if kind == 0:
                pieces.append(rng.integers(0, 256, m, dtype=np.uint8).tobytes())
            elif kind == 1:
                pieces.append(bytes([int(rng.integers(97, 100))]) * m)  # RLE
            else:
                pieces.append((b"lorem ipsum dolor sit amet " * (m // 27 + 1))[:m])
            n += m
        data = b"".join(pieces)[: 90000 + trial * 7]
        body, ulen = _body(pymodel.compress(data))
        assert decode_via(entry, body, ulen) == (errors.E_OK, data), trial


@pytest.mark.parametrize("entry", STREAM_ENTRIES)
def test_mutated_stream_matches_oracle(entry, urls10k):
    # a corrupted whole stream: same bytes or the same error as the model
    body, ulen = _body(pymodel.compress(urls10k[:100000]))
    rng = np.random.default_rng(17)
    for _ in range(3):
        bad = bytearray(body)
        bad[int(rng.integers(0, len(bad)))] ^= int(rng.integers(1, 256))
        assert decode_via(entry, bytes(bad), ulen) == oracle(bytes(bad), ulen)


@pytest.mark.parametrize("entry", STREAM_ENTRIES)
def test_encoder_stream_through_stream_decoder(entry, urls10k):
    from csnappy_jax.ops import encode_fused

    data = urls10k[:100000]
    body, ulen = _body(encode_fused.compress_np(data))
    assert decode_via(entry, body, ulen) == (errors.E_OK, data)
