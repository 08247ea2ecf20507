"""CLI harness parity tests (cl_tester + block_compressor drivers)."""
import pathlib
import subprocess
import sys

import pytest

from csnappy_jax import cli

DATA = pathlib.Path(__file__).parent / "data"


def test_file_roundtrip(tmp_path, urls10k):
    src = DATA / "urls.10K"
    comp = tmp_path / "u.snappy"
    back = tmp_path / "u.out"
    assert cli.main(["file", "-c", "-b", "jax", str(src), str(comp)]) == 0
    assert cli.main(["file", "-d", "-b", "jax", str(comp), str(back)]) == 0
    assert back.read_bytes() == urls10k


def test_file_decompress_golden(tmp_path, urls10k):
    out = tmp_path / "g.out"
    assert cli.main(["file", "-d", str(DATA / "urls.10K.snappy"), str(out)]) == 0
    assert out.read_bytes() == urls10k


def test_file_baddata_fails(tmp_path):
    assert cli.main(["file", "-d", str(DATA / "baddata3.snappy"), str(tmp_path / "x")]) == 1


def test_selftests():
    assert cli.main(["file", "-S", "c", "-b", "py"]) == 0
    assert cli.main(["file", "-S", "d", "-b", "py"]) == 0


def test_selftests_jax_backend():
    assert cli.main(["file", "-S", "c"]) == 0
    assert cli.main(["file", "-S", "d"]) == 0


def test_block_roundtrip(tmp_path, urls10k):
    src = tmp_path / "in.bin"
    src.write_bytes(urls10k[:100000])
    cont = tmp_path / "c.blk"
    back = tmp_path / "out.bin"
    assert cli.main(["block", "-c", "-m", "snappy", str(src), str(cont)]) == 0
    assert cli.main(["block", "-d", "-m", "snappy", str(cont), str(back)]) == 0
    assert back.read_bytes() == src.read_bytes()


def test_block_zlib(tmp_path, urls10k):
    src = tmp_path / "in.bin"
    src.write_bytes(urls10k[:50000])
    cont = tmp_path / "c.blk"
    back = tmp_path / "out.bin"
    assert cli.main(["block", "-c", "-m", "zlib", str(src), str(cont)]) == 0
    assert cli.main(["block", "-d", "-m", "zlib", str(cont), str(back)]) == 0
    assert back.read_bytes() == src.read_bytes()


def test_stdin_stdout_pipe(urls10k):
    """mkfifo-style pipe test of the reference Makefile (Makefile:21-26),
    via subprocess pipes."""
    data = urls10k[:40000]
    env = {"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin"}
    import os

    env.update({k: v for k, v in os.environ.items() if k not in env})
    p1 = subprocess.run(
        [sys.executable, "-m", "csnappy_jax.cli", "file", "-c", "-b", "py"],
        input=data,
        capture_output=True,
        env=env,
        cwd=str(pathlib.Path(__file__).parent.parent),
    )
    assert p1.returncode == 0, p1.stderr
    p2 = subprocess.run(
        [sys.executable, "-m", "csnappy_jax.cli", "file", "-d", "-b", "py"],
        input=p1.stdout,
        capture_output=True,
        env=env,
        cwd=str(pathlib.Path(__file__).parent.parent),
    )
    assert p2.returncode == 0, p2.stderr
    assert p2.stdout == data
