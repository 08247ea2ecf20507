"""The codec on the card: runs only where a GPU is JAX's default device.

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""
import subprocess
import sys

import pytest

from csnappy_jax import api
from csnappy_jax.models import pymodel
from csnappy_jax.runtime import container

from conftest import ROOT


@pytest.mark.gpu
def test_golden_and_compress_on_card(gpu, urls10k, urls10k_snappy):
    assert api.decompress(urls10k_snappy) == urls10k
    comp = api.compress(urls10k)
    assert len(comp) == 354567
    assert pymodel.decompress(comp) == urls10k


@pytest.mark.gpu
def test_page_store_on_card(gpu, urls10k):
    cont, _ = container.compress_blocks(urls10k, page_size=4096)
    assert container.decompress_blocks(cont, page_size=4096)[0] == urls10k


def test_chip_smoke_refuses_without_gpu(tmp_path):
    # the CPU is no accelerator: no result line, nonzero exit
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
                       text=True, env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin"},
                       timeout=300)
    assert r.returncode != 0 and '"ok"' not in r.stdout
    # alone in a directory, away from the checkout, it refuses too
    lone = tmp_path / "chip_smoke.py"
    lone.write_bytes((ROOT / "chip_smoke.py").read_bytes())
    r = subprocess.run([sys.executable, str(lone)], capture_output=True, text=True,
                       cwd=tmp_path, timeout=300)
    assert r.returncode != 0 and '"ok"' not in r.stdout
