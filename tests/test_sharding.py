"""Mesh data-parallel codec: same bytes regardless of sharding (SURVEY.md §4)."""
import jax
import numpy as np
import pytest

from csnappy_jax.models import pymodel
from csnappy_jax.parallel import mesh as pmesh


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) == 8, "tests expect the 8-device CPU mesh"
    return pmesh.default_mesh()


def test_compress_sharded_matches_single(urls10k, mesh8):
    sharded = pmesh.compress_sharded(urls10k, mesh8)
    assert pymodel.decompress(sharded) == urls10k
    # sharding must not change the bytes: single-device mesh == 8-device mesh
    single = pmesh.compress_sharded(urls10k, pmesh.default_mesh(n=1))
    assert sharded == single


def test_decompress_fragments_sharded(urls10k, mesh8):
    blocks = [urls10k[i : i + 32768] for i in range(0, len(urls10k), 32768)]
    frags = [pymodel.compress_fragment(b) for b in blocks]
    outs = pmesh.decompress_fragments_sharded(frags, [len(b) for b in blocks], mesh8)
    assert b"".join(outs) == urls10k


def test_per_fragment_dst_limit_enforced(urls10k, mesh8):
    # ADVICE r1 (low): a fragment producing more than its declared out_len
    # must be flagged E_OUTPUT_OVERRUN, not silently returned oversized
    from csnappy_jax import errors

    good = urls10k[:32768]
    frags = [pymodel.compress_fragment(good), pymodel.compress_fragment(good)]
    with pytest.raises(errors.SnappyError) as ei:
        pmesh.decompress_fragments_sharded(frags, [len(good), len(good) - 1], mesh8)
    assert ei.value.code == errors.E_OUTPUT_OVERRUN


def test_uneven_block_count(urls10k, mesh8):
    # 5 blocks over 8 devices: padding blocks must stay inert
    data = urls10k[: 32768 * 4 + 777]
    sharded = pmesh.compress_sharded(data, mesh8)
    assert pymodel.decompress(sharded) == data
