"""Regression tests for the round-2 advisor findings (ADVICE.md r2)."""
import numpy as np
import pytest

from csnappy_jax import api
from csnappy_jax.errors import SnappyError, E_OUTPUT_OVERRUN
from csnappy_jax.models import pymodel


def test_dst_len_zero_is_overrun():
    # b'\x00X' is a 1-byte literal: with dst_len=0 it must be
    # E_OUTPUT_OVERRUN, not E_OK with one byte of data (ADVICE r2 #1)
    with pytest.raises(SnappyError) as ei:
        api.decompress_noheader(b"\x00X", 0)
    assert ei.value.code == E_OUTPUT_OVERRUN


def test_dst_len_zero_empty_stream_ok():
    assert api.decompress_noheader(b"", 0) == b""


def test_sharded_fragment_odd_out_cap():
    # 4608-byte output rounds to 4608 under the old 128-multiple rule, which
    # is not a whole 1024 group — crashed at trace time (ADVICE r2 #2)
    from csnappy_jax.parallel import mesh

    data = bytes(np.random.default_rng(7).integers(65, 91, 4608, dtype=np.uint8))
    frag = pymodel.compress_fragment(data[: 4608])
    outs = mesh.decompress_fragments_sharded([frag], [4608])
    assert outs[0] == data[:4608]
