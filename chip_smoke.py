#!/usr/bin/env python3
"""Smoke run of the codec on one GPU, through the entry points users call.

    python3 chip_smoke.py          # one card: five phases
    python3 chip_smoke.py --four   # the mesh path on four cards, nothing else

Phases on one card, each checked against the plain references (the Python
model ``models/pymodel.py`` and the from-spec ``csrc/spec_decoder.c``):

  1. golden   api.decompress of the reference-encoded urls.10K stream
  2. compress api.compress(urls.10K): 354,567 B, decodable by both references
  3. safety   hostile and malformed streams get the reference's error codes
  4. foreign  streams whose tags and copies cross 32 KiB segments, and
              copies reaching past 32 KiB, as other encoders write them;
              then 64 MiB in upstream Snappy's 64 KiB blocks, decoded whole
  5. pages    a 256 MiB store of 4 KiB pages through the block container,
              beside the native host codec on the same bytes

The card's name and power limit come first; every phase raises on failure.
The last line of a good run is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a GPU as JAX's default device the script exits nonzero and prints
no such line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import struct
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
DATA = ROOT / "tests" / "data"
PAGE = 4096
FAKE = b"\x32\xc4foooooo"        # truncated-literal vector (cl_tester.c:167)
FOREIGN_BYTES = 64 << 20


def card() -> str:
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return (r.stdout or r.stderr).strip()


def timed(fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, time.perf_counter() - t0


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def spec_decoder():
    lib = ctypes.CDLL(str(ROOT / "csrc" / "libspec_decoder.so"))
    for fn in (lib.spec_snappy_decode, lib.spec_snappy_decode_elements):
        fn.restype = ctypes.c_long
        fn.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t]
    return lib


def spec_decode(lib, stream: bytes, cap: int, headerless: bool = False) -> bytes:
    out = ctypes.create_string_buffer(max(cap, 1))
    fn = lib.spec_snappy_decode_elements if headerless else lib.spec_snappy_decode
    got = fn(stream, len(stream), out, cap)
    check(got >= 0, f"spec decoder rejected the stream (rc={got})")
    return out.raw[:got]


def expect_error(code, fn, *args) -> None:
    from csnappy_jax.errors import SnappyError

    try:
        fn(*args)
    except SnappyError as e:
        check(code is None or e.code == code, f"expected error {code}, got {e.code}")
        return
    raise AssertionError(f"expected error {code}, got success")


def lit(payload: bytes) -> bytes:
    from csnappy_jax.models import wire

    s = bytearray()
    wire.emit_literal(s, payload)
    return bytes(s)


def copy(length: int, offset: int, kind: int) -> bytes:
    nbytes = 2 if kind == 2 else 4
    return bytes([kind | ((length - 1) << 2)]) + offset.to_bytes(nbytes, "little")


def upstream_stream(data: bytes) -> bytes:
    """Headerless stream of ``data`` in upstream Snappy's 64 KiB blocks: each
    block's second half opens with a copy reaching 30,000 bytes back, so
    copies and tags cross 32 KiB segments and the stream decodes whole."""
    from csnappy_jax.models import wire
    from csnappy_jax.runtime import native

    parts = []
    for a in range(0, len(data), 1 << 16):
        first, second = data[a : a + (1 << 15)], data[a + (1 << 15) : a + (1 << 16)]
        parts.append(native.compress_fragment(first))
        if len(second) > 64:
            parts.append(copy(64, 30000, wire.TAG_COPY_2))
            second = second[64:]
        if second:
            parts.append(native.compress_fragment(second))
    return b"".join(parts)


def container_pages(cont: bytes):
    """(page index, compressed page) for every page the container compressed."""
    import numpy as np

    from csnappy_jax.runtime.container import RAW_BIT

    (nr,) = struct.unpack_from("<I", cont, 0)
    raw = np.frombuffer(cont, "<u4", count=nr, offset=4)
    at = 4 + 4 * nr
    for i, v in enumerate(raw.tolist()):
        n = v & ~RAW_BIT
        if v != PAGE and not v & RAW_BIT:
            yield i, cont[at : at + n]
        at += n


def one_card() -> None:
    import jax
    import numpy as np

    from csnappy_jax import api, errors
    from csnappy_jax.models import pymodel, wire
    from csnappy_jax.ops import batching, decode_jnp
    from csnappy_jax.runtime import container, native
    from csnappy_jax.tools.corpus import page_store

    spec = spec_decoder()
    urls = (DATA / "urls.10K").read_bytes()
    golden = (DATA / "urls.10K.snappy").read_bytes()

    # 1. golden
    out, cold = timed(api.decompress, golden)
    check(out == urls, "golden stream decode mismatch")
    out, warm = timed(api.decompress, golden)
    check(out == urls, "golden stream decode mismatch (warm)")
    print(f"phase 1 golden: ok, {len(urls)} B, first call {cold:.3f} s, then {warm:.4f} s", flush=True)

    # 2. compress
    comp, cold = timed(api.compress, urls, backend="jax")
    check(len(comp) == 354567, f"urls.10K compressed to {len(comp)} B, not 354,567")
    comp2, warm = timed(api.compress, urls, backend="jax")
    check(comp2 == comp, "compress is not deterministic")
    check(spec_decode(spec, comp, len(urls) + 1) == urls, "spec decoder disagrees")
    check(pymodel.decompress(comp) == urls, "Python model disagrees")
    check(api.decompress(comp) == urls, "api round trip mismatch")
    print(f"phase 2 compress: ok, {len(comp)} B (reference 357,267), "
          f"first call {cold:.3f} s, then {warm:.4f} s", flush=True)

    # 3. safety
    expect_error(None, api.decompress, (DATA / "baddata3.snappy").read_bytes())
    expect_error(None, api.decompress, FAKE)
    offset_first = lit(b"ab") + bytes([wire.TAG_COPY_1, 50]) + lit(b"c" * 60)
    overrun_first = pymodel.compress_fragment(b"y" * 5000)[:-1]
    expect_error(errors.E_DATA_MALFORMED, api.decompress_noheader, offset_first, 4)
    expect_error(errors.E_OUTPUT_OVERRUN, api.decompress_noheader, overrun_first, 4096)
    expect_error(errors.E_OUTPUT_INSUF, api.decompress, comp, len(urls) - 1)
    print("phase 3 safety: ok (baddata3, fake, priority -5 and -3, dst_len short)", flush=True)
    # 100 MB of copies claiming 2^31 + 64 bytes into 1 GiB: no output sum
    # may wrap, so the decoder agrees with the native reference's code
    copies = copy(64, 64, wire.TAG_COPY_2) * (1 << 25)
    for name, stream in (("overrun", lit(b"a" * 64) + copies),
                         ("bad offset first", lit(b"a" * 64) + copy(4, 0, wire.TAG_COPY_2) + copies)):
        want = errors.E_OK
        try:
            native.decompress_noheader(stream, 1 << 30)
        except errors.SnappyError as e:
            want = e.code
        (_, _, got), t = timed(decode_jnp.decompress_noheader_np, np.frombuffer(stream, np.uint8), 1 << 30)
        check(got == want != errors.E_OK, f"{name}: decoder {got}, native reference {want}")
        print(f"phase 3 safety, {len(stream)} B claiming over 2^31 B ({name}): {got} as the "
              f"native reference, in {t:.3f} s", flush=True)

    # 4. foreign streams
    rng = np.random.default_rng(3)
    raw = rng.integers(0, 256, 50000, dtype=np.uint8).tobytes()
    crossing = lit(raw) + copy(64, 1000, wire.TAG_COPY_2)
    far = lit(raw) + copy(64, 39000, wire.TAG_COPY_2) + copy(32, 40010, wire.TAG_COPY_4)
    for name, stream, n in (("crossing", crossing, 50064), ("far-offset", far, 50096)):
        want = pymodel.decompress_noheader(stream, n)
        got, t = timed(api.decompress_noheader, stream, n)
        check(got == want, f"{name} stream mismatch")
        print(f"phase 4 foreign {name}: ok, {n} B in {t:.3f} s", flush=True)
    data = page_store(FOREIGN_BYTES)
    stream = upstream_stream(data)
    check(native.scan_segments(stream, len(data))[0] == native.SCAN_CROSSING,
          "the upstream-style stream should not split into 32 KiB blocks")
    want = spec_decode(spec, stream, len(data), headerless=True)
    got, cold = timed(api.decompress_noheader, stream, len(data))
    check(got == want, "upstream-style stream mismatch")
    got, warm = timed(api.decompress_noheader, stream, len(data))
    check(got == want, "upstream-style stream mismatch (warm)")
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    print(f"phase 4 foreign upstream-style: ok, {len(stream)} B -> {len(data)} B whole, "
          f"first call {cold:.3f} s, then {warm:.3f} s ({len(data) / 1e6 / warm:.1f} MB/s); "
          f"peak device memory so far {peak} B", flush=True)

    # 5. page store
    data = page_store()
    enc_blocks = batching.blocks_per_dispatch(PAGE + wire.max_compressed_length(PAGE))
    dec_blocks = batching.blocks_per_dispatch(2 * decode_jnp.bucket(PAGE))
    print(f"phase 5 pages: {len(data) // PAGE} pages of {PAGE} B; blocks per dispatch: "
          f"encode {enc_blocks}, decode {dec_blocks}", flush=True)
    (cont, stats), c_cold = timed(container.compress_blocks, data, PAGE)
    (cont2, _), c_warm = timed(container.compress_blocks, data, PAGE)
    check(cont2 == cont, "container compress is not deterministic")
    (back, _), d_cold = timed(container.decompress_blocks, cont, PAGE)
    check(back == data, "page store round trip mismatch")
    (back, _), d_warm = timed(container.decompress_blocks, cont, PAGE)
    check(back == data, "page store round trip mismatch (warm)")
    checked = 0
    for i, page in container_pages(cont):
        want = data[i * PAGE : (i + 1) * PAGE]
        check(spec_decode(spec, page, PAGE, headerless=True) == want, f"page {i}: spec decoder")
        checked += 1
    pages = [data[i : i + PAGE] for i in range(0, len(data), PAGE)]
    ncomp, nc_t = timed(lambda: [native.compress_fragment(p) for p in pages])
    nback, nd_t = timed(lambda: [native.decompress_noheader(c, PAGE) for c in ncomp])
    check(b"".join(nback) == data, "native host codec round trip mismatch")
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    mb = len(data) / 1e6
    print(f"phase 5 pages: ok, {len(data)} B -> {len(cont)} B container "
          f"({stats.histogram[0]} raw pages), {checked} compressed pages checked "
          f"by the spec decoder", flush=True)
    print(f"phase 5 compress: first {c_cold:.3f} s, then {c_warm:.3f} s "
          f"({mb / c_warm:.1f} MB/s); decompress: first {d_cold:.3f} s, then "
          f"{d_warm:.3f} s ({mb / d_warm:.1f} MB/s)", flush=True)
    print(f"phase 5 native host codec, one core, page by page: compress {nc_t:.3f} s "
          f"({mb / nc_t:.1f} MB/s, {sum(map(len, ncomp))} B), decompress {nd_t:.3f} s "
          f"({mb / nd_t:.1f} MB/s)", flush=True)
    print(f"peak device memory: {peak} B", flush=True)


def four_cards() -> None:
    import jax

    from csnappy_jax import api
    from csnappy_jax.models import wire
    from csnappy_jax.parallel import mesh as pmesh
    from csnappy_jax.runtime import native
    from csnappy_jax.tools.corpus import page_store

    check(len(jax.devices()) >= 4, f"--four needs 4 devices, JAX has {len(jax.devices())}")
    mesh = pmesh.default_mesh(n=4)
    data = page_store()
    one, t1 = timed(api.compress, data)
    sharded, cold = timed(pmesh.compress_sharded, data, mesh)
    check(sharded == one, "sharded stream differs from the one-card stream")
    sharded, warm = timed(pmesh.compress_sharded, data, mesh)
    check(sharded == one, "sharded stream differs from the one-card stream (warm)")
    print(f"four compress: ok, {len(data)} B -> {len(one)} B, byte-identical to one card "
          f"(one card {t1:.3f} s; four cards first {cold:.3f} s, then {warm:.3f} s)", flush=True)
    ulen, hdr = wire.varint_decode(one)
    body = one[hdr:]
    rc, offs, _ = native.scan_segments(body, ulen, wire.BLOCK_SIZE)
    check(rc == 0, f"native scan rc {rc}")
    ends = list(offs[1:]) + [len(body)]
    frags = [body[a:b] for a, b in zip(offs, ends)]
    out_lens = [min(wire.BLOCK_SIZE, ulen - i * wire.BLOCK_SIZE) for i in range(len(frags))]
    outs, cold = timed(pmesh.decompress_fragments_sharded, frags, out_lens, mesh)
    check(b"".join(outs) == data, "sharded decode mismatch")
    outs, warm = timed(pmesh.decompress_fragments_sharded, frags, out_lens, mesh)
    check(b"".join(outs) == data, "sharded decode mismatch (warm)")
    print(f"four decompress: ok, {len(frags)} fragments, byte-identical to the input "
          f"(first {cold:.3f} s, then {warm:.3f} s)", flush=True)
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use") for d in mesh.devices.flat]
    print(f"peak device memory per card: {peaks} B", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true", help="run the mesh path on four cards")
    args = ap.parse_args()
    print(card(), flush=True)
    if not (ROOT / "csnappy_jax").is_dir():
        print("error: chip_smoke.py must sit at the root of a checkout", file=sys.stderr)
        return 2
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"error: JAX's default device is {dev.platform}, not a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from csnappy_jax.config import use_compile_cache

    print(f"compile cache: {use_compile_cache()}", flush=True)
    _, t = timed(subprocess.run, ["make", "-C", str(ROOT / "csrc")], check=True,
                 capture_output=True)
    print(f"native build: {t:.1f} s", flush=True)
    (four_cards if args.four else one_card)()
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
