"""Batched block encoder: valid grammar, oracle-decodable, ratio bar, and
byte identity with the streams of the encoder it replaced."""
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from csnappy_jax import api
from csnappy_jax.models import pymodel, wire
from csnappy_jax.ops import batching, encode_fused
from csnappy_jax.tools.corpus import corpus


def _enc1(data: bytes, bs: int = 4096) -> bytes:
    arr = np.zeros((1, bs), np.uint8)
    arr[0, : len(data)] = np.frombuffer(data, np.uint8)
    comp, lens = encode_fused.encode_blocks(arr, np.array([len(data)], np.int32))
    return comp[0, : lens[0]].tobytes()


@pytest.fixture(scope="module")
def files():
    return corpus()


@pytest.mark.parametrize(
    "data",
    [
        b"",
        b"a",
        b"hello world hello world hello",
        b"a" * 4096,                       # RLE
        b"ab" * 2048,
        bytes(range(256)) * 16,            # far matches
        b"the quick brown fox jumps over the lazy dog " * 90,
    ],
)
def test_roundtrip_via_oracle(data):
    frag = _enc1(data)
    assert pymodel.decompress_noheader(frag, 4096) == data
    assert len(frag) <= wire.max_compressed_length(len(data)) or not data


def test_incompressible_within_bound():
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, 4000, dtype=np.uint8).tobytes()
    frag = _enc1(data)
    assert pymodel.decompress_noheader(frag, 4096) == data
    assert len(frag) <= wire.max_compressed_length(4000)


def test_batched_blocks(urls10k):
    nb = 8
    pages = np.zeros((nb, 4096), np.uint8)
    pages.reshape(-1)[: nb * 4096] = np.frombuffer(urls10k[: nb * 4096], np.uint8)
    lens = np.full((nb,), 4096, np.int32)
    comp, clens = encode_fused.encode_blocks(pages, lens)
    for i in range(nb):
        frag = comp[i, : clens[i]].tobytes()
        assert pymodel.decompress_noheader(frag, 4096) == urls10k[i * 4096 : (i + 1) * 4096]


def test_ratio_beats_reference_on_urls_head(urls10k):
    # first 32K block: match lengths come from a 4+4*EXTRAS-byte carried LCP
    # plus the staircase, trading ~2% ratio against the exhaustive oracle;
    # the whole-file bar is test_api_compress_urls_size
    data = urls10k[:32768]
    frag = _enc1(data, bs=32768)
    assert pymodel.decompress_noheader(frag, 32768) == data
    assert len(frag) <= len(pymodel.compress_fragment(data)) * 1.04


def test_grammar_decoded_by_fused_decoder(urls10k):
    # cross-module: device encoder -> device decoder
    from csnappy_jax.ops import decode_jnp

    data = urls10k[:4096]
    frag = _enc1(data)
    arr = np.frombuffer(frag, np.uint8)[None, :]
    out, produced, status = decode_jnp.decode_blocks(arr, np.array([len(frag)]), 4096)
    assert int(status[0]) == 0
    assert out[0, : len(data)].tobytes() == data


def test_fuzz_roundtrip():
    rng = np.random.default_rng(9)
    for trial in range(8):
        n = int(rng.integers(1, 4096))
        if trial % 2:
            data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        else:
            data = (b"abcdefgh" * (n // 8 + 1))[:n]
        frag = _enc1(data)
        assert pymodel.decompress_noheader(frag, 4096) == data, trial


# (corpus file, block size, bytes encoded, stream length, SHA-256 of the
# stream) as written by the batched encoder this one replaced, which ran the
# same match index, walk and emission rules; the encoder must reproduce
# every stream byte for byte
IDENTITY = [
    ("urls.10K", 32768, 702087, 354567, "5256f284350389ff2eb5851de505fb99c1a96da8bf2fe3c8d75c12c530e094a1"),
    ("urls.10K", 4096, 702087, 415575, "e40ddf87a8c1f2b749b8f1f488847a6c5e2187540eb9400833e672229849d894"),
    ("text.1M", 32768, 131072, 61446, "807ea92f8bf42949206e2aa60e24bd5c1296f448ab288ecedfeee6a4018e935c"),
    ("text.1M", 4096, 131072, 67540, "ba7c288707cc666e421b79c2d9979834ea7d42097d401e27f14f7a2dac97c9a3"),
    ("text.64K", 32768, 65536, 30649, "7ac1c7f7f69767114c3da242b36a2d8d7b75946ef2771b3a4c2d2a368c1a75b5"),
    ("text.64K", 4096, 65536, 33728, "3fc12e665ee6728cdb5bbd5c8e4e45b369c31485e6418dd680061a14f1f25ba9"),
    ("html.512K", 32768, 131072, 20487, "5846f4201d853ff9c44a4514de06ab6b7754407c75717bdc2239c7b0c8a1f7f3"),
    ("html.512K", 4096, 131072, 23579, "d9109988c544f0590dc1174ebf98cd0fe5c9d97cc3d54212dbc3587d596d8d0b"),
    ("binrec.1M", 32768, 131072, 93469, "45c28cb16db093d4248b1907f7c93c1d078662856ec3dfcd9ea6ad215a7e9649"),
    ("binrec.1M", 4096, 131072, 97262, "60d6c6ebe6443b692d3f5340c2382c75c0ccb053c3d57bce8bda6df4dec8e498"),
    ("rle.512K", 32768, 131072, 6606, "f451ff1c405480964b781771aa50112a8667001f3292865f7db25ec49059b7a5"),
    ("rle.512K", 4096, 131072, 6699, "f1427fceb184a9059379e8d7c901eae06e497e643a5d265989740735cac86e7a"),
    ("random.512K", 32768, 131072, 131087, "68a4a899ca638b89a306cdea37e652ecf6ca652f243a0bef2707f1b1b34dbf01"),
    ("random.512K", 4096, 131072, 131171, "2eecd1713237cb20df540a2089a14a9978a9924e5acb13dd3fb15e32fa7feb20"),
    ("random.64K", 32768, 65536, 65547, "9a004f92111afe4d8d6f7b07cb3b8112b4a4181ed3303aa4ad8a2ecdc208a6b2"),
    ("random.64K", 4096, 65536, 65587, "d1bf1e31282326b1a6e4f5d87cc9f878a1bacf1698f4b939338d1fbcc677b266"),
    ("mixed.1M", 32768, 131072, 74209, "5dfca85792af44285143e8d35b6cc188af439c18035614c6174de4e563c0eabf"),
    ("mixed.1M", 4096, 131072, 77002, "597b23bb52d6174b09113c4b02234523aae1dfe8c439050894f8e69f0609a401"),
]


@pytest.mark.parametrize("name,bs,n,clen,sha", IDENTITY, ids=[f"{r[0]}-{r[1]}" for r in IDENTITY])
def test_identity_sha256(files, name, bs, n, clen, sha):
    out = encode_fused.compress_np(files[name][:n], bs)
    assert len(out) == clen
    assert hashlib.sha256(out).hexdigest() == sha


def test_api_compress_urls_size(urls10k):
    comp = api.compress(urls10k)
    assert len(comp) == 354567 <= 357267      # reference: 357,267 B
    assert api.decompress(comp) == urls10k


def _scalar_walk(w: np.ndarray) -> np.ndarray:
    """The greedy parse as the reference runs it: one position at a time."""
    BS = len(w)
    commit = np.zeros(BS, bool)
    p = 0
    while p < BS:
        commit[p] = bool(w[p] & encode_fused.STORE)
        p += int(w[p] & encode_fused.ADVANCE)
    return commit


@pytest.mark.parametrize("name", sorted(corpus()))
def test_walk_matches_scalar_walk(files, name):
    BS = 32768
    data = np.zeros((2, BS), np.uint8)
    raw = np.frombuffer(files[name][: 2 * BS - 1000], np.uint8)
    data.reshape(-1)[: len(raw)] = raw
    blens = jnp.asarray([BS, BS - 1000], jnp.int32)
    has, cand, ml = encode_fused._match_index(jnp.asarray(data, jnp.int32), blens)
    wtab = encode_fused.walk_table(has, ml)
    got = np.asarray(jax.vmap(encode_fused._walk)(wtab))
    w = np.asarray(wtab)
    assert (w & encode_fused.ADVANCE).min() >= 1
    for b in range(2):
        want = _scalar_walk(w[b])
        np.testing.assert_array_equal(got[b], want)
        # commits lie inside the block, each after the previous copy
        c = np.nonzero(want)[0]
        m = np.asarray(ml)[b, c]
        assert (m >= wire.MIN_MATCH).all() and (c + m <= int(blens[b])).all()
        assert (c[1:] >= c[:-1] + m[:-1]).all()


def test_dispatches_split_and_pad():
    per = batching.blocks_per_dispatch(4096 + 4810)
    assert per & (per - 1) == 0 and per * (4096 + 4810) <= batching.DISPATCH_BYTES
    d = batching.dispatches(2 * per + 3, 4096 + 4810)
    assert [(s, e) for s, e, _ in d] == [(0, per), (per, 2 * per), (2 * per, 2 * per + 3)]
    assert [p for _, _, p in d] == [per, per, 4]
    assert batching.dispatches(0, 4096) == []
    # sharded: every dispatch divides into equal per-device shards
    assert batching.dispatches(5, 4096, devices=4) == [(0, 5, 8)]
    assert batching.blocks_per_dispatch(batching.DISPATCH_BYTES * 2) == 1


def test_encode_blocks_across_dispatches(monkeypatch, urls10k):
    # a batch larger than one dispatch comes back whole and in order
    pages = np.frombuffer(urls10k[: 11 * 4096], np.uint8).reshape(11, 4096)
    lens = np.full((11,), 4096, np.int32)
    want, wlens = encode_fused.encode_blocks(pages, lens)
    monkeypatch.setattr(batching, "DISPATCH_BYTES", 4 * (4096 + 4810))
    assert len(batching.dispatches(11, 4096 + 4810)) == 3
    got, glens = encode_fused.encode_blocks(pages, lens)
    np.testing.assert_array_equal(glens, wlens)
    np.testing.assert_array_equal(got, want)


def test_encode_blocks_empty_and_widths():
    comp, lens = encode_fused.encode_blocks(np.zeros((0, 4096), np.uint8), np.zeros((0,), np.int32))
    assert comp.shape == (0, wire.max_compressed_length(4096)) and lens.shape == (0,)
    # zero-length blocks emit nothing; odd widths share the next power of two
    comp, lens = encode_fused.encode_blocks(np.zeros((3, 3000), np.uint8), np.array([0, 1, 3000]))
    assert comp.shape[1] == wire.max_compressed_length(4096)
    assert lens[0] == 0 and pymodel.decompress_noheader(comp[1, : lens[1]].tobytes(), 1) == b"\0"
    assert pymodel.decompress_noheader(comp[2, : lens[2]].tobytes(), 3000) == bytes(3000)
    with pytest.raises(ValueError):
        encode_fused.block_width(32769)
