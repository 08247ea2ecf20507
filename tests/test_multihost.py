"""2-process jax.distributed loopback (BASELINE config 5, VERDICT r1 #6).

Spawns two real processes with a TCP coordinator on CPU devices, compresses
half the block sequence in each, and checks the in-order assembled stream
matches the single-process encoder byte-for-byte.
"""
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    p = s.getsockname()[1]
    s.close()
    return p


@pytest.mark.timeout(600)
def test_two_process_loopback(tmp_path, urls10k):
    port = _free_port()
    n_bytes = 65536
    procs = []
    for rank in range(2):
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        env.setdefault("JAX_COMPILATION_CACHE_DIR", str(ROOT / ".jax_cache"))
        out = tmp_path / f"part{rank}.npz"
        procs.append(
            subprocess.Popen(
                [sys.executable, "-m", "csnappy_jax.parallel.multihost",
                 "--worker", "--rank", str(rank), "--nprocs", "2",
                 "--port", str(port), "--out", str(out), "--nbytes", str(n_bytes)],
                env=env, cwd=str(ROOT),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            )
        )
    outs = []
    for p in procs:
        so, se = p.communicate(timeout=570)
        assert p.returncode == 0, se.decode()[-2000:]
    parts = [np.load(tmp_path / f"part{r}.npz") for r in range(2)]
    # both hosts computed identical global offsets (the replicated gather)
    np.testing.assert_array_equal(parts[0]["offsets"], parts[1]["offsets"])
    # assemble in order and compare to the single-process stream
    data = urls10k[:n_bytes]
    from csnappy_jax.ops import encode_fused

    bs = 4096
    nb = int(parts[0]["nb"])
    per = int(parts[0]["per"])
    clens = np.concatenate([parts[0]["clens"], parts[1]["clens"]])
    comp = np.concatenate([parts[0]["comp"], parts[1]["comp"]])
    full = (len(data) + bs - 1) // bs
    pages = np.zeros((nb, bs), np.uint8)
    pages.reshape(-1)[: len(data)] = np.frombuffer(data, np.uint8)
    lens = np.zeros((nb,), np.int32)
    lens[:full] = bs
    lens[full - 1] = len(data) - (full - 1) * bs
    ref_comp, ref_lens = encode_fused.encode_blocks(pages, lens)
    np.testing.assert_array_equal(clens[:full], ref_lens[:full])
    stream = b"".join(comp[i, : clens[i]].tobytes() for i in range(full))
    ref_stream = b"".join(ref_comp[i, : ref_lens[i]].tobytes() for i in range(full))
    assert stream == ref_stream
    from csnappy_jax.models import pymodel

    got = b"".join(
        pymodel.decompress_noheader(comp[i, : clens[i]].tobytes(), bs)
        for i in range(full)
    )
    assert got == data
