#!/usr/bin/env python
"""Benchmark runner — prints one JSON line.

Runs on JAX's default device, which must be a GPU listed in PEAK_GBPS.
The work is the page store of ``tools/corpus.page_store``: 256 MiB of the
seeded corpus as 4 KiB pages (five times the card's L2), through the block
container, host bytes in and host bytes out.  Each time is the host clock
around one call, the best of REPS calls after a warm-up call that compiles:

  * compress: ``container.compress_blocks`` of the store;
  * decompress: ``container.decompress_blocks`` of its container;
  * native: the host's native codec, one core, page by page, on the same
    bytes (the rate a GPU path has to beat).

Rates are of uncompressed bytes.  Each direction's rate is also given as a
share of the card's memory bandwidth: the bytes a call must move (input read
plus output written, one byte each) over its time, over the data-sheet peak.
"""
import json
import pathlib
import sys
import time

import jax

sys.path.insert(0, str(pathlib.Path(__file__).parent))

from csnappy_jax import api
from csnappy_jax.config import use_compile_cache
from csnappy_jax.runtime import container, native
from csnappy_jax.tools.corpus import page_store

DATA_DIR = pathlib.Path(__file__).parent / "tests" / "data"
# peak device-memory bandwidth by jax device_kind, GB/s
PEAK_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,   # H100 SXM, NVIDIA data sheet
}
PAGE = 4096
REPS = 3


def best_time(fn, *args):
    """(result, best seconds of REPS calls) after one warm-up call."""
    out = fn(*args)
    best = float("inf")
    for _ in range(REPS):
        t0 = time.perf_counter()
        fn(*args)
        best = min(best, time.perf_counter() - t0)
    return out, best


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX's default device is {dev.platform}")
    if dev.device_kind not in PEAK_GBPS:
        raise SystemExit(f"no peak bandwidth known for {dev.device_kind!r}; add it to PEAK_GBPS")
    peak = PEAK_GBPS[dev.device_kind] * 1e9
    use_compile_cache()
    data = page_store()
    n = len(data)

    (cont, _), t_enc = best_time(container.compress_blocks, data, PAGE)
    (back, _), t_dec = best_time(container.decompress_blocks, cont, PAGE)
    assert back == data, "page store round trip mismatch"

    pages = [data[i : i + PAGE] for i in range(0, n, PAGE)]
    t0 = time.perf_counter()
    ncomp = [native.compress_fragment(p) for p in pages]
    t_nenc = time.perf_counter() - t0
    t0 = time.perf_counter()
    nback = [native.decompress_noheader(c, PAGE) for c in ncomp]
    t_ndec = time.perf_counter() - t0
    assert b"".join(nback) == data, "native round trip mismatch"

    urls = (DATA_DIR / "urls.10K").read_bytes()
    moved = n + len(cont)
    print(json.dumps({
        "metric": "page_decompress_GBps",
        "value": n / t_dec / 1e9,
        "unit": "GB/s",
        "page_compress_GBps": n / t_enc / 1e9,
        "native_decompress_GBps": n / t_ndec / 1e9,
        "native_compress_GBps": n / t_nenc / 1e9,
        "decompress_bandwidth_share": moved / t_dec / peak,
        "compress_bandwidth_share": moved / t_enc / peak,
        "store_bytes": n,
        "container_bytes": len(cont),
        "urls10k_compressed_bytes": len(api.compress(urls)),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
