"""C++ host runtime: conformance, interop with all backends, compactor."""
import numpy as np
import pytest

from csnappy_jax import api, errors
from csnappy_jax.models import pymodel, wire
from csnappy_jax.runtime import native

pytestmark = pytest.mark.skipif(not native.available(), reason="native lib not built")


def test_golden_decode(urls10k, urls10k_snappy):
    assert native.decompress(urls10k_snappy, len(urls10k)) == urls10k


def test_unaligned_decode(unaligned_bin, unaligned_snappy):
    assert native.decompress(unaligned_snappy, len(unaligned_bin)) == unaligned_bin


def test_baddata3_rejected(baddata3):
    with pytest.raises(errors.SnappyError):
        native.decompress(baddata3, 1 << 22)


def test_roundtrip_and_ratio(urls10k):
    comp = native.compress(urls10k)
    assert pymodel.decompress(comp) == urls10k       # py oracle decodes it
    assert native.decompress(comp, len(urls10k)) == urls10k
    assert len(comp) <= 357267, f"native ratio regression: {len(comp)}"


def test_cross_backend_interop(urls10k):
    data = urls10k[:100000]
    for enc in ("py", "native", "jax"):
        comp = api.compress(data, backend=enc)
        for dec in ("py", "native", "jax"):
            assert api.decompress(comp, backend=dec) == data, (enc, dec)


def test_error_codes(urls10k, urls10k_snappy):
    with pytest.raises(errors.SnappyError) as ei:
        native.decompress(urls10k_snappy, 100)
    assert ei.value.code == errors.E_OUTPUT_INSUF
    with pytest.raises(errors.SnappyError) as ei:
        native.decompress(b"\xff\xff\xff\xff\xff\xff", 10)
    assert ei.value.code == errors.E_HEADER_BAD
    hdr = wire.varint_decode(urls10k_snappy)[1]
    with pytest.raises(errors.SnappyError) as ei:
        native.decompress_noheader(urls10k_snappy[hdr:], len(urls10k) - 1)
    assert ei.value.code == errors.E_OUTPUT_OVERRUN
    with pytest.raises(errors.SnappyError):
        native.decompress(b"\x32\xc4foooooo", 4096)


@pytest.mark.parametrize("data", [b"", b"x", b"a" * 70000, bytes(range(256)) * 200])
def test_roundtrip_patterns(data):
    comp = native.compress(data)
    assert native.decompress(comp, len(data)) == data
    assert pymodel.decompress(comp) == data


def test_compact():
    padded = np.zeros((3, 16), np.uint8)
    padded[0, :4] = [1, 2, 3, 4]
    padded[1, :2] = [5, 6]
    padded[2, :3] = [7, 8, 9]
    assert native.compact(padded, np.array([4, 2, 3])) == bytes([1, 2, 3, 4, 5, 6, 7, 8, 9])


# --------------------------------------------------------------------------
# scan_segments differential coverage (ADVICE r3): the whole-stream routing
# scan must agree with the pymodel oracle on validity, and its offsets must
# reproduce the stream's 32 KiB output segmentation exactly.
# --------------------------------------------------------------------------


def _oracle_verdict(body: bytes, dst_len: int):
    try:
        out = pymodel.decompress_noheader(body, dst_len)
        return True, out
    except errors.SnappyError:
        return False, b""


def test_scan_segments_golden(urls10k, urls10k_snappy):
    ulen, hdr = wire.varint_decode(urls10k_snappy)
    body = urls10k_snappy[hdr:]
    rc, offs, produced = native.scan_segments(np.frombuffer(body, np.uint8), ulen)
    assert rc == native.SCAN_SEGMENTABLE
    assert produced == ulen
    assert len(offs) == (ulen + 32767) // 32768
    # each offset decodes independently to exactly one 32 KiB segment
    ends = list(offs[1:]) + [len(body)]
    for k, (o, e) in enumerate(zip(offs, ends)):
        seg = pymodel.decompress_noheader(body[o:e], 32768)
        assert seg == urls10k[k * 32768 : (k + 1) * 32768]


def test_scan_segments_differential_fuzz():
    rng = np.random.default_rng(1234)
    base = bytes(rng.integers(97, 105, 90000, dtype=np.uint8))  # compressible
    for trial in range(40):
        n = int(rng.integers(1, 80000))
        start = int(rng.integers(0, len(base) - n))
        data = base[start : start + n]
        stream = pymodel.compress(data)
        ulen, hdr = wire.varint_decode(stream)
        body = bytearray(stream[hdr:])
        mode = trial % 4
        if mode == 1 and len(body) > 8:            # corrupt a byte
            body[int(rng.integers(0, len(body)))] ^= int(rng.integers(1, 256))
        elif mode == 2 and len(body) > 8:          # truncate
            del body[int(rng.integers(1, len(body))):]
        elif mode == 3:                            # short output claim
            ulen = max(0, ulen - int(rng.integers(1, 5000)))
        rc, offs, produced = native.scan_segments(bytes(body), ulen)
        ok, out = _oracle_verdict(bytes(body), ulen)
        if rc == native.SCAN_SEGMENTABLE:
            # scan says legal; the oracle must agree and produce `produced`
            assert ok and len(out) == produced, (trial, rc, produced, len(out), ok)
        elif rc < 0:
            assert not ok or len(out) != ulen, (trial, rc)


def test_routed_api_segmentable(urls10k):
    data = urls10k[:150000]
    stream = pymodel.compress(data)
    ulen, hdr = wire.varint_decode(stream)
    assert api.decompress_noheader(stream[hdr:], ulen) == data


def test_routed_api_crossing_offset_32768():
    # a legal foreign stream whose copy reaches exactly 32768 back across a
    # segment boundary: scan classifies it crossing; api must still decode
    data = bytes(np.random.default_rng(7).integers(0, 256, 33000, dtype=np.uint8))
    s = bytearray()
    wire.emit_literal(s, data[:32900])
    s += bytes([wire.TAG_COPY_2 | ((64 - 1) << 2)]) + (32768).to_bytes(2, "little")
    want = data[:32900] + data[32900 - 32768 : 32900 - 32768 + 64]
    assert api.decompress_noheader(bytes(s), len(want)) == want


def test_routed_api_far_offset():
    # offsets > 32768 (a foreign 64 KiB-block encoder): beyond the stream
    # kernel's history ring; must route to the general decoder and decode
    data = bytes(np.random.default_rng(9).integers(0, 256, 40000, dtype=np.uint8))
    s = bytearray()
    wire.emit_literal(s, data)
    s += bytes([wire.TAG_COPY_4 | ((64 - 1) << 2)]) + (40000).to_bytes(4, "little")
    want = data + data[:64]
    assert api.decompress_noheader(bytes(s), len(want)) == want
