"""Benchmark-table and zram-sim harness tests."""
import pathlib

from csnappy_jax.tools import benchtable, zramsim

DATA = pathlib.Path(__file__).parent / "data"


def test_benchtable_native(capsys):
    assert benchtable.main(["-b", "native", str(DATA / "urls.10K")]) == 0
    out = capsys.readouterr().out
    assert "urls.10K" in out and "MB/s" in out


def test_zramsim_roundtrip(tmp_path, urls10k):
    (tmp_path / "a.bin").write_bytes(urls10k[:50000])
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "b.bin").write_bytes(urls10k[50000:120000])
    r = zramsim.run(str(tmp_path), page_size=4096)
    assert r["nr_files"] == 2
    assert r["orig_data_size"] == 120000
    assert 0 < r["compr_data_size"] < r["orig_data_size"]


def test_corpus_deterministic_and_diverse():
    from csnappy_jax.tools.corpus import corpus

    c1 = corpus()
    c2 = corpus()
    assert set(c1) == set(c2) and all(c1[k] == c2[k] for k in c1)
    assert len(c1) >= 8
    import zlib

    ratios = {k: len(zlib.compress(v[:65536], 1)) / min(len(v), 65536) for k, v in c1.items()}
    assert min(ratios.values()) < 0.35      # highly compressible member
    assert max(ratios.values()) > 0.95      # incompressible member


def test_benchtable_py_backend(tmp_path, capsys):
    from csnappy_jax.tools import benchtable

    p = tmp_path / "x"
    p.write_bytes(b"hello world " * 400)
    assert benchtable.main(["-b", "py", str(p)]) == 0
    out = capsys.readouterr().out
    assert "MB/s" in out and "ratio" in out


def test_optrace_reduction():
    from csnappy_jax.tools import optrace

    # overlapping, nested and disjoint intervals: the union is 0-15 and 20-25
    assert optrace.busy_ns([(0, 10), (5, 15), (6, 7), (20, 25)]) == 20
    assert optrace.busy_ns([]) == 0
    events = [("scatter", 0, 5), ("sort", 5, 3), ("scatter", 9, 4), ("copy", 20, 1)]
    assert optrace.top_ops(events, n=2) == [("scatter", 2, 9), ("sort", 1, 3)]


def test_page_store_tiles_the_corpus():
    from csnappy_jax.tools.corpus import PAGE_STORE_BYTES, corpus, page_store

    unit = b"".join(v for _, v in sorted(corpus().items()))
    n = len(unit) + 12345           # one whole unit and the start of the next
    store = page_store(n)
    assert len(store) == n and store == unit + unit[:12345]
    assert page_store(n) == store
    assert PAGE_STORE_BYTES == 65536 * 4096
