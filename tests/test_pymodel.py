"""Conformance tests for the Python format model (the oracle).

Mirrors the reference's Makefile-driven checks (SURVEY.md §4): golden
round-trip on urls.10K, baddata3 rejection, unaligned_uint64 decode,
short-buffer error codes, truncated-literal rejection.
"""
import pytest

from csnappy_jax import errors
from csnappy_jax.models import pymodel, wire

# The 8-byte truncated stream from the reference's decode selftest
# (cl_tester.c:167): varint len 50, then a 50-byte literal with 7 payload bytes.
FAKE = b"\x32\xc4foooooo"


def test_golden_decode(urls10k, urls10k_snappy):
    assert pymodel.decompress(urls10k_snappy) == urls10k


def test_unaligned_decode(unaligned_bin, unaligned_snappy):
    assert pymodel.decompress(unaligned_snappy) == unaligned_bin


def test_baddata3_rejected(baddata3):
    with pytest.raises(errors.SnappyError):
        pymodel.decompress(baddata3, dst_len=1 << 22)


def test_fake_truncated_literal_rejected():
    with pytest.raises(errors.SnappyError) as ei:
        pymodel.decompress(FAKE)
    assert ei.value.code == errors.E_DATA_MALFORMED
    with pytest.raises(errors.SnappyError):
        pymodel.decompress_noheader(FAKE, dst_len=1 << 16)


def test_output_insufficient(urls10k_snappy):
    with pytest.raises(errors.SnappyError) as ei:
        pymodel.decompress(urls10k_snappy, dst_len=100)
    assert ei.value.code == errors.E_OUTPUT_INSUF


def test_noheader_output_overrun(urls10k, urls10k_snappy):
    hdr = wire.varint_decode(urls10k_snappy)[1]
    with pytest.raises(errors.SnappyError) as ei:
        pymodel.decompress_noheader(urls10k_snappy[hdr:], dst_len=len(urls10k) - 1)
    assert ei.value.code == errors.E_OUTPUT_OVERRUN


def test_input_not_consumed():
    # the reference Python model's stricter header-mode contract
    # (pysnappy_decompress.py:57-60): output exactly full with input tags
    # remaining is E_INPUT_NOT_CONSUMED (-4) in header mode; the noheader
    # contract (like the C) folds it into E_OUTPUT_OVERRUN
    body = bytearray()
    wire.emit_literal(body, b"abcd")
    wire.emit_literal(body, b"xy")          # trailing tags past the header length
    stream = wire.varint_encode(4) + bytes(body)
    with pytest.raises(errors.SnappyError) as ei:
        pymodel.decompress(stream)
    assert ei.value.code == errors.E_INPUT_NOT_CONSUMED
    with pytest.raises(errors.SnappyError) as ei2:
        pymodel.decompress_noheader(bytes(body), dst_len=4)
    assert ei2.value.code == errors.E_OUTPUT_OVERRUN


def test_roundtrip_urls(urls10k):
    comp = pymodel.compress(urls10k)
    assert pymodel.decompress(comp) == urls10k
    # ratio parity: exhaustive matcher must not lose to the reference's lossy
    # table (357,267 B golden size, BASELINE.md)
    assert len(comp) <= 357267
    assert len(comp) <= wire.max_compressed_length(len(urls10k))


@pytest.mark.parametrize(
    "data",
    [
        b"",
        b"a",
        b"abcd" * 3,
        b"a" * 100000,  # RLE: overlapping copies with offset 1
        bytes(range(256)) * 300,
        b"the quick brown fox jumps over the lazy dog " * 1000,
    ],
)
def test_roundtrip_patterns(data):
    comp = pymodel.compress(data)
    assert pymodel.decompress(comp) == data
    assert len(comp) <= wire.max_compressed_length(len(data))


def test_roundtrip_random_incompressible():
    import random

    rng = random.Random(1234)
    data = bytes(rng.randrange(256) for _ in range(70000))
    comp = pymodel.compress(data)
    assert pymodel.decompress(comp) == data
    assert len(comp) <= wire.max_compressed_length(len(data))


def test_varint():
    for v in [0, 1, 127, 128, 300, 1 << 21, (1 << 32) - 1]:
        enc = wire.varint_encode(v)
        assert wire.varint_decode(enc) == (v, len(enc))
    with pytest.raises(ValueError):
        wire.varint_decode(b"\xff\xff\xff\xff\xff\x01")  # > 5 bytes
    with pytest.raises(ValueError):
        wire.varint_decode(b"\xff\xff")  # truncated


def test_opcode_table_shape():
    t = wire.make_opcode_table()
    assert t.shape == (256, 4)
    # literal 0x00 → length 1; copy1 base; copy2 len 64 ceiling
    assert t[0x00].tolist() == [1, 0, 1, 0]
    assert t[0xFC].tolist() == [0, 4, 1, 0]  # literal u=63 → 4 trailer bytes
    assert (t[1::4, 1] == 1).all()  # every copy1 has 1 trailer byte
    assert (t[2::4, 1] == 2).all()
    assert (t[3::4, 1] == 4).all()


class TestStreamingDecode:
    """Bounded-window streaming decode (OutputBuffer.py analog)."""

    def test_urls_with_window_memory(self, urls10k, urls10k_snappy):
        from csnappy_jax.models import wire

        ulen, hdr = wire.varint_decode(urls10k_snappy)
        chunks = []
        n = pymodel.decompress_stream(
            urls10k_snappy[hdr:], chunks.append, ulen, window=32768
        )
        assert n == ulen
        assert b"".join(chunks) == urls10k

    def test_overlap_and_small_window(self):
        data = b"ab" * 1000 + b"xyz" * 500
        comp = pymodel.compress_fragment(data)
        chunks = []
        n = pymodel.decompress_stream(comp, chunks.append, len(data), window=4096)
        assert b"".join(chunks) == data

    def test_offset_beyond_window_rejected(self):
        from csnappy_jax import errors
        from csnappy_jax.models import wire

        data = bytes(range(256)) * 40  # has far matches past 8K
        comp = pymodel.compress_fragment(b"Q" * 9000 + data[:200] + b"Q" * 9000)
        # a window smaller than the largest offset must be detected, not
        # silently corrupt
        try:
            pymodel.decompress_stream(comp, lambda c: None, 1 << 20, window=256)
        except errors.SnappyError as e:
            assert e.code == errors.E_DATA_MALFORMED


def test_second_matcher_table(urls10k):
    # the lossy-table matcher (second independent model match-finder, the
    # pysnappy_compress.py:71-96 analog): any strategy must emit a
    # conformant stream that the oracle decodes bit-exact
    data = urls10k[:32768]
    frag_dict = pymodel.compress_fragment(data)
    frag_tab = pymodel.compress_fragment_table(data)
    assert pymodel.decompress_noheader(frag_tab, len(data)) == data
    assert frag_dict != frag_tab              # genuinely different strategies
    # lossy table compresses worse than the exhaustive dict, like the
    # reference pair, but must still compress real text
    assert len(frag_dict) <= len(frag_tab) < len(data)


def test_second_matcher_roundtrip_patterns():
    for data in (b"", b"a", b"ab" * 5000, bytes(range(256)) * 10,
                 b"\x00" * 4000, b"abcabcabcabcx" * 100):
        frag = pymodel.compress_fragment_table(data)
        assert pymodel.decompress_noheader(frag, len(data)) == data
