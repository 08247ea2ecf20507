"""Public API surface (csnappy.h parity) + block container tests."""
import numpy as np
import pytest

from csnappy_jax import api, errors
from csnappy_jax.models import wire
from csnappy_jax.runtime import container

FAKE = b"\x32\xc4foooooo"


class TestApi:
    def test_max_compressed_length(self):
        assert api.max_compressed_length(32768) == 32 + 32768 + 32768 // 6

    def test_get_uncompressed_length(self, urls10k_snappy, urls10k):
        ulen, n = api.get_uncompressed_length(urls10k_snappy)
        assert ulen == len(urls10k)
        with pytest.raises(errors.SnappyError) as ei:
            api.get_uncompressed_length(b"\xff\xff\xff\xff\xff\xff")
        assert ei.value.code == errors.E_HEADER_BAD

    @pytest.mark.parametrize("backend", ["py", "jax"])
    def test_roundtrip_both_backends(self, backend, urls10k):
        data = urls10k[:70000]
        comp = api.compress(data, backend=backend)
        assert api.decompress(comp, backend=backend) == data
        # cross-backend interop
        other = "jax" if backend == "py" else "py"
        assert api.decompress(comp, backend=other) == data

    def test_fragment_roundtrip(self, urls10k):
        data = urls10k[:32768]
        frag = api.compress_fragment(data)
        assert api.decompress_noheader(frag, len(data)) == data
        assert len(frag) <= api.max_compressed_length(len(data))
        with pytest.raises(ValueError):
            api.compress_fragment(b"x" * 40000)

    def test_decompress_errors(self, urls10k_snappy, urls10k):
        with pytest.raises(errors.SnappyError) as ei:
            api.decompress(urls10k_snappy, dst_len=10)
        assert ei.value.code == errors.E_OUTPUT_INSUF
        with pytest.raises(errors.SnappyError):
            api.decompress(FAKE)

    def test_hostile_header_length_rejected(self):
        # ADVICE r1 (low): a 5-byte header claiming 2^32-1 bytes must not
        # drive a multi-GiB allocation — impossible expansions are rejected
        hostile = wire.varint_encode((1 << 32) - 1) + b"\x00a"
        with pytest.raises(errors.SnappyError) as ei:
            api.decompress(hostile)
        assert ei.value.code == errors.E_HEADER_BAD
        # a legitimate high-expansion stream still decodes: 1-byte literal
        # then max-length offset-1 copies
        data = b"z" * 30000
        comp = api.compress(data, backend="py")
        assert api.decompress(comp) == data

    def test_selftest_compression_contract(self):
        """cl_tester -S c analog (cl_tester.c:127-165): the compressor must
        stay within max_compressed_length even on incompressible input —
        asserted directly instead of via a guard page + SIGSEGV."""
        rng = np.random.default_rng(0)
        data = rng.integers(0, 256, size=4096 + 100, dtype=np.uint8).tobytes()
        comp = api.compress(data)
        assert len(comp) <= api.max_compressed_length(len(data)) + wire.MAX_VARINT32_BYTES

    def test_selftest_decompression(self):
        """cl_tester -S d analog (cl_tester.c:167-238)."""
        rng = np.random.default_rng(1)
        data = rng.integers(0, 256, size=4096 + 100, dtype=np.uint8).tobytes()
        comp = api.compress(data)
        assert api.decompress(comp) == data
        with pytest.raises(errors.SnappyError) as ei:
            api.decompress(comp, dst_len=len(data) - 1)
        assert ei.value.code == errors.E_OUTPUT_INSUF
        hdr = wire.varint_decode(comp)[1]
        with pytest.raises(errors.SnappyError) as ei:
            api.decompress_noheader(comp[hdr:], dst_len=len(data) - 1)
        assert ei.value.code == errors.E_OUTPUT_OVERRUN
        for fn in (lambda: api.decompress(FAKE), lambda: api.decompress_noheader(FAKE, 4096)):
            with pytest.raises(errors.SnappyError):
                fn()


class TestContainer:
    def test_roundtrip_snappy(self, urls10k):
        data = urls10k[: 4096 * 9 + 1234]  # 9 full pages + short tail
        cont, stats = container.compress_blocks(data, page_size=4096)
        assert stats.nr_pages == 10
        out, _ = container.decompress_blocks(cont, page_size=4096)
        assert out == data

    def test_roundtrip_zlib(self, urls10k):
        data = urls10k[:20000]
        cont, _ = container.compress_blocks(data, page_size=4096, codec="zlib")
        out, _ = container.decompress_blocks(cont, page_size=4096, codec="zlib")
        assert out == data

    def test_raw_fallback(self):
        rng = np.random.default_rng(2)
        data = rng.integers(0, 256, size=4096 * 4, dtype=np.uint8).tobytes()
        cont, stats = container.compress_blocks(data, page_size=4096)
        assert stats.histogram[0] == 4  # all pages incompressible -> raw
        # container size = header + table + raw pages
        assert len(cont) == 4 + 16 + len(data)
        out, _ = container.decompress_blocks(cont, page_size=4096)
        assert out == data

    @pytest.mark.parametrize("tail", [4093, 4094, 4095, 100, 1])
    @pytest.mark.parametrize("codec", ["snappy", "zlib"])
    def test_incompressible_tail_page(self, tail, codec):
        # ADVICE r1 (medium): an incompressible 4093-4095B tail compresses to
        # exactly page_size bytes and must not be misread as a raw full page
        rng = np.random.default_rng(3)
        data = rng.integers(0, 256, size=4096 + tail, dtype=np.uint8).tobytes()
        cont, _ = container.compress_blocks(data, page_size=4096, codec=codec)
        out, _ = container.decompress_blocks(cont, page_size=4096, codec=codec)
        assert out == data

    def test_truncated_container_rejected(self, urls10k):
        cont, _ = container.compress_blocks(urls10k[:10000], page_size=4096)
        with pytest.raises(errors.SnappyError):
            container.decompress_blocks(cont[: len(cont) - 10], page_size=4096)
        with pytest.raises(errors.SnappyError):
            container.decompress_blocks(cont[:3], page_size=4096)

    def test_empty(self):
        cont, stats = container.compress_blocks(b"", page_size=4096)
        out, _ = container.decompress_blocks(cont, page_size=4096)
        assert out == b"" and stats.nr_pages == 0
