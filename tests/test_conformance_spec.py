"""Encoder conformance against the INDEPENDENT from-spec decoder (C14).

The reference proved its encoder by feeding its streams to Google's
upstream snappy decoder (snappy_tester.patch:44-117).  No third-party
snappy exists on this image, so csrc/spec_decoder.c — written from the
public format description alone, byte-at-a-time, sharing no code or design
with any decoder in this repo — plays that role: every encoder backend's
output must decode bit-exact through it, and it must agree with the oracle
on the golden vectors.  If our streams were only decodable by our own
code, these tests fail.
"""
import ctypes
import pathlib
import subprocess

import numpy as np
import pytest

from csnappy_jax.models import pymodel, wire

CSRC = pathlib.Path(__file__).parents[1] / "csrc"
SO = CSRC / "libspec_decoder.so"


@pytest.fixture(scope="module")
def spec():
    if not SO.exists():
        subprocess.run(["make", "-C", str(CSRC)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(SO))
    lib.spec_snappy_decode.restype = ctypes.c_long
    lib.spec_snappy_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t
    ]
    lib.spec_snappy_decode_elements.restype = ctypes.c_long
    lib.spec_snappy_decode_elements.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t
    ]
    return lib


def _decode(lib, stream: bytes, cap: int) -> bytes:
    out = ctypes.create_string_buffer(cap)
    got = lib.spec_snappy_decode(stream, len(stream), out, cap)
    assert got >= 0, f"spec decoder rejected the stream: rc={got}"
    return out.raw[:got]


def _decode_elements(lib, body: bytes, cap: int):
    out = ctypes.create_string_buffer(cap)
    got = lib.spec_snappy_decode_elements(body, len(body), out, cap)
    return got, out.raw[: max(got, 0)]


def test_spec_decoder_agrees_on_golden(spec, urls10k, urls10k_snappy):
    # the independent decoder itself validated against the reference-encoded
    # golden pair before it is trusted to judge our encoders
    assert _decode(spec, urls10k_snappy, len(urls10k) + 1) == urls10k


def test_spec_decoder_rejects_baddata3(spec, baddata3):
    out = ctypes.create_string_buffer(1 << 22)
    got = spec.spec_snappy_decode(baddata3, len(baddata3), out, 1 << 22)
    assert got < 0


def test_py_encoder_streams_decode_independently(spec, urls10k):
    comp = pymodel.compress(urls10k)
    assert _decode(spec, comp, len(urls10k) + 1) == urls10k


def test_native_encoder_streams_decode_independently(spec, urls10k):
    from csnappy_jax.runtime import native

    if not native.available():
        pytest.skip("native runtime not built")
    comp = native.compress(urls10k)
    assert _decode(spec, comp, len(urls10k) + 1) == urls10k


def test_jax_encoder_streams_decode_independently(spec, urls10k):
    from csnappy_jax.ops import encode_fused

    comp = encode_fused.compress_np(urls10k)
    assert _decode(spec, comp, len(urls10k) + 1) == urls10k


def test_fuzz_encoders_vs_spec_decoder(spec):
    # structured fuzz: repetitive, periodic, random, and mixed payloads
    # through every encoder; the independent decoder must reproduce each
    rng = np.random.default_rng(11)
    cases = []
    for n in (1, 2, 63, 64, 100, 4096, 32768):
        cases.append(rng.integers(0, 256, n, dtype=np.uint8).tobytes())
        cases.append((b"abcdef" * (n // 6 + 1))[:n])
        cases.append(bytes(n))
        lo = rng.integers(0, 4, n, dtype=np.uint8) * 65
        cases.append(lo.tobytes())
    for data in cases:
        frag = pymodel.compress_fragment(data)
        got, out = _decode_elements(spec, frag, len(data) + 1)
        assert got == len(data) and out == data, f"py frag len={len(data)}"
        frag2 = pymodel.compress_fragment_table(data)
        got2, out2 = _decode_elements(spec, frag2, len(data) + 1)
        assert got2 == len(data) and out2 == data, f"table frag len={len(data)}"


def test_spec_decoder_matches_oracle_on_mutations(spec, urls10k):
    # error-agreement fuzz: mutated streams — the spec decoder and the
    # oracle must agree on accept/reject, and byte-exactly when accepting
    comp = pymodel.compress(urls10k[:50000])
    rng = np.random.default_rng(13)
    for _ in range(40):
        buf = bytearray(comp)
        for _k in range(int(rng.integers(1, 4))):
            buf[int(rng.integers(0, len(buf)))] = int(rng.integers(0, 256))
        stream = bytes(buf)
        try:
            want = pymodel.decompress(stream, dst_len=1 << 20)
            ok = True
        except Exception:
            ok = False
        out = ctypes.create_string_buffer(1 << 20)
        got = spec.spec_snappy_decode(stream, len(stream), out, 1 << 20)
        if ok:
            assert got == len(want) and out.raw[:got] == want
        else:
            assert got < 0
