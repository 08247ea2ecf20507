"""Benchmark-table generator — userspace_benchmark.txt parity (C14/C17).

Reproduces the reference's published table format (file, in->out bytes,
ratio, compress MB/s, decompress MB/s) per backend.  The reference produced
its table with Google snappy's patched snappy_unittest
(snappy_tester.patch:44-117); here the harness is built in.

Every backend is timed end to end through the public API, host bytes in
and host bytes out (for jax: batched 32 KiB blocks on the default device,
transfers included), best of N wall-clock runs after a warm-up run.

Usage:
  python -m csnappy_jax.tools.benchtable [-b jax|py|native] FILES...
  python -m csnappy_jax.tools.benchtable --corpus        # generated corpus
"""
from __future__ import annotations

import argparse
import sys
import time

from .. import api
from ..config import use_compile_cache


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return max(time.perf_counter() - t0, 1e-9)


def _measure(data: bytes, backend: str, reps: int = 3) -> dict:
    comp = api.compress(data, backend=backend)   # warm-up: compiles for jax
    t_c = min(_timed(lambda: api.compress(data, backend=backend)) for _ in range(reps))
    out = api.decompress(comp, backend=backend)
    assert out == data, "roundtrip mismatch"
    t_d = min(_timed(lambda: api.decompress(comp, backend=backend)) for _ in range(reps))
    return dict(n_in=len(data), n_out=len(comp), t_c=t_c, t_d=t_d)


def measure(data: bytes, backend: str) -> dict:
    m = _measure(data, backend)
    m["ratio"] = 100.0 * m["n_out"] / max(m["n_in"], 1)
    m["c_mbps"] = m["n_in"] / m["t_c"] / 1e6
    m["d_mbps"] = m["n_in"] / m["t_d"] / 1e6
    return m


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-b", "--backend", default="jax", choices=["jax", "py", "native"])
    ap.add_argument("--corpus", action="store_true", help="run the generated corpus")
    ap.add_argument("files", nargs="*")
    args = ap.parse_args(argv)
    use_compile_cache()
    items: list[tuple[str, bytes]] = []
    if args.corpus:
        from .corpus import corpus

        items += sorted(corpus().items())
    for path in args.files:
        with open(path, "rb") as f:
            items.append((path.rsplit("/", 1)[-1], f.read()))
    if not items:
        ap.error("no files (pass paths or --corpus)")
    print(f"backend={args.backend}")
    print(f"{'file':<14} {'in->out bytes':>21} {'ratio':>7} {'comp':>12} {'decomp':>12}")
    for name, data in items:
        m = measure(data, args.backend)
        print(
            f"{name:<14} {m['n_in']:>9} -> {m['n_out']:>8} {m['ratio']:>6.1f}% "
            f"{m['c_mbps']:>9.1f}MB/s {m['d_mbps']:>9.1f}MB/s",
            flush=True,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
