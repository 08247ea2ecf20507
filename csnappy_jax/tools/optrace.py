"""Top device operations of the page codec, from one profiler trace.

    python -m csnappy_jax.tools.optrace [--out DIR]

Compresses and decompresses the page store of ``tools/corpus.page_store``
(256 MiB of 4 KiB pages, the bytes chip_smoke.py and bench.py time) through
the block container once (compiling everything), then traces
one more pass of each direction with ``jax.profiler`` and prints, per
direction, the window's wall time, the device's busy share, and the
operations that took the most device time.  Needs a GPU as JAX's default
device; the trace files stay under ``--out``.
"""
from __future__ import annotations

import argparse
import collections
import pathlib
import sys
import time


def busy_ns(intervals) -> int:
    """Length of the union of (start_ns, end_ns) intervals."""
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def top_ops(events, n: int = 10) -> list[tuple[str, int, int]]:
    """(name, count, total_ns) of the ``n`` names with the most device time;
    events are (name, start_ns, duration_ns)."""
    count, total = collections.Counter(), collections.Counter()
    for name, _, dur in events:
        count[name] += 1
        total[name] += dur
    return [(k, count[k], v) for k, v in total.most_common(n)]


def device_events(trace_dir: pathlib.Path):
    """(name, start_ns, duration_ns) of every GPU stream event in the trace."""
    import jax

    (path,) = sorted(trace_dir.glob("plugins/profile/*/*.xplane.pb"))[-1:]
    data = jax.profiler.ProfileData.from_file(str(path))
    events, seen = [], []
    for plane in data.planes:
        seen.append(f"{plane.name}: {[line.name for line in plane.lines]}")
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if line.name.startswith("Stream"):
                events += [(e.name, e.start_ns, e.duration_ns) for e in line.events]
    if not events:
        raise RuntimeError(f"no GPU stream events in {path}; planes: {seen}")
    return events


def main(argv=None) -> int:
    import jax

    from ..config import use_compile_cache
    from ..runtime import container
    from .corpus import page_store

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out/optrace")
    args = ap.parse_args(argv)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"error: JAX's default device is {dev.platform}, not a GPU", file=sys.stderr)
        return 1
    use_compile_cache()
    data = page_store()
    cont, _ = container.compress_blocks(data)
    assert container.decompress_blocks(cont)[0] == data
    for name, fn, arg in (("compress", container.compress_blocks, data),
                          ("decompress", container.decompress_blocks, cont)):
        out = pathlib.Path(args.out) / name
        with jax.profiler.trace(str(out)):
            t0 = time.perf_counter_ns()
            fn(arg)
            wall = time.perf_counter_ns() - t0
        events = device_events(out)
        busy = busy_ns((s, s + d) for _, s, d in events)
        print(f"{name}: {len(data)} B of 4 KiB pages on {dev.device_kind}; window {wall / 1e6:.3f} ms, "
              f"device busy {busy / 1e6:.3f} ms ({100 * busy / wall:.1f}% of the window)")
        for op, cnt, tot in top_ops(events):
            print(f"  {tot / 1e6:10.3f} ms {100 * tot / busy:5.1f}%  x{cnt:<5d} {op}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
