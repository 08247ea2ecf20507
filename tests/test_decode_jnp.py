"""XLA decoder vs the oracle and the golden vectors (CPU backend)."""
import jax.numpy as jnp
import numpy as np
import pytest

from csnappy_jax import errors
from csnappy_jax.models import pymodel, wire
from csnappy_jax.ops import decode_jnp


def _decode(body: bytes, dst_len: int):
    return decode_jnp.decompress_noheader_np(np.frombuffer(body, np.uint8), dst_len)


def _strip_header(stream: bytes) -> tuple[bytes, int]:
    ulen, hdr = wire.varint_decode(stream)
    return stream[hdr:], ulen


def test_golden_decode(urls10k, urls10k_snappy):
    body, ulen = _strip_header(urls10k_snappy)
    out, produced, status = _decode(body, ulen)
    assert status == errors.E_OK
    assert produced == len(urls10k)
    assert out.tobytes() == urls10k


def test_unaligned_decode(unaligned_bin, unaligned_snappy):
    body, ulen = _strip_header(unaligned_snappy)
    out, produced, status = _decode(body, ulen)
    assert status == errors.E_OK
    assert out.tobytes() == unaligned_bin


def test_baddata3_rejected(baddata3):
    body, ulen = _strip_header(baddata3)
    out, produced, status = _decode(body, 1 << 22)
    assert status < 0
    assert produced == 0


def test_fake_truncated_literal():
    out, produced, status = _decode(b"\xc4foooooo", 1 << 12)
    assert status == errors.E_DATA_MALFORMED


def test_output_overrun(urls10k, urls10k_snappy):
    body, ulen = _strip_header(urls10k_snappy)
    _, _, status = _decode(body, ulen - 1)
    assert status == errors.E_OUTPUT_OVERRUN


def test_offset_zero_rejected():
    # literal 'ab' then a copy with offset 0
    bad = bytes([1 << 2]) + b"ab"[:2]
    bad = bytes([(2 - 1) << 2]) + b"ab" + bytes([wire.TAG_COPY_1 | (0 << 2) | 0, 0])
    out, produced, status = _decode(bad, 64)
    assert status == errors.E_DATA_MALFORMED


def test_offset_too_far_rejected():
    bad = bytes([(2 - 1) << 2]) + b"ab" + bytes([wire.TAG_COPY_2 | (3 << 2), 100, 0])
    out, produced, status = _decode(bad, 64)
    assert status == errors.E_DATA_MALFORMED


@pytest.mark.parametrize(
    "data",
    [
        b"",
        b"a",
        b"abcd" * 3,
        b"a" * 100000,  # RLE — deep overlapped-copy chains
        b"ab" * 50000,
        bytes(range(256)) * 40,
        b"the quick brown fox jumps over the lazy dog " * 500,
    ],
)
def test_roundtrip_vs_oracle(data):
    comp = pymodel.compress(data)
    body, ulen = _strip_header(comp)
    out, produced, status = _decode(body, ulen)
    assert status == errors.E_OK
    assert out.tobytes() == data


def test_roundtrip_random():
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, size=50000, dtype=np.uint8).tobytes()
    comp = pymodel.compress(data)
    body, ulen = _strip_header(comp)
    out, _, status = _decode(body, ulen)
    assert status == errors.E_OK
    assert out.tobytes() == data


def test_decode_blocks_batched(urls10k):
    """zram mode: independent 32KB fragments, batched."""
    blocks = [urls10k[i : i + 32768] for i in range(0, 32768 * 8, 32768)]
    comps = [pymodel.compress_fragment(b) for b in blocks]
    P = max(len(c) for c in comps)
    P = ((P + 511) // 512) * 512
    arr = np.zeros((len(comps), P), np.uint8)
    for i, c in enumerate(comps):
        arr[i, : len(c)] = np.frombuffer(c, np.uint8)
    lens = np.array([len(c) for c in comps], np.int32)
    out, produced, status = decode_jnp.decode_blocks(arr, lens, 32768)
    assert (status == errors.E_OK).all()
    for i, b in enumerate(blocks):
        assert produced[i] == len(b)
        assert out[i, : len(b)].tobytes() == b


def test_copy4_accepted():
    """COPY_4 must decode even though our encoder never emits it."""
    lit = b"0123456789abcdef"
    stream = bytearray()
    wire.emit_literal(stream, lit)
    stream += bytes([wire.TAG_COPY_4 | ((8 - 1) << 2)]) + (16).to_bytes(4, "little")
    out, produced, status = _decode(bytes(stream), 64)
    assert status == errors.E_OK
    assert out.tobytes() == lit + lit[:8]


@pytest.mark.parametrize("cap", [7, 100, 1 << 20, decode_jnp.SATURATE])
def test_saturating_prefix(cap):
    # exact below the cap, pinned at it above: a sum can never wrap
    x = np.array([3, 0, 5, 2, 60, 1, 1], np.int32)
    excl, total = decode_jnp._saturating_prefix(jnp.asarray(x), cap)
    want = np.minimum(np.concatenate([[0], np.cumsum(x)[:-1]]), cap)
    assert np.asarray(excl).tolist() == want.tolist()
    assert int(total) == min(int(x.sum()), cap)


def test_saturating_prefix_near_int32_limit():
    big = np.full((4,), (1 << 30) + 1, np.int32)
    excl, total = decode_jnp._saturating_prefix(jnp.asarray(big))
    assert np.asarray(excl).tolist() == [0, (1 << 30) + 1, decode_jnp.SATURATE, decode_jnp.SATURATE]
    assert int(total) == decode_jnp.SATURATE
