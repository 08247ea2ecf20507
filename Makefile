# Build/test harness — reference Makefile parity (C11).

PY ?= python

.PHONY: test test_gpu smoke native cl_test selftest bench block_test clean

# CPU tests on an 8-device virtual mesh (tests/conftest.py)
test:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/ -q

# tests that need the card, one process on it
test_gpu:
	JAX_PLATFORMS=cuda $(PY) -m pytest tests/ -q -m gpu

# the main path on one GPU: five checked phases, JSON result last
smoke:
	$(PY) chip_smoke.py

native:
	$(MAKE) -C csrc

# round-trip check on the golden corpus through the CLI, like the
# reference's cl_test target (Makefile:21-26)
cl_test: native
	mkdir -p build
	$(PY) -m csnappy_jax.cli file -c -b native tests/data/urls.10K build/u.sz
	$(PY) -m csnappy_jax.cli file -d -b native build/u.sz build/u.out
	cmp build/u.out tests/data/urls.10K && echo "cl_test passed"

selftest:
	$(PY) -m csnappy_jax.cli file -S c -b native
	$(PY) -m csnappy_jax.cli file -S d -b native

block_test: native
	mkdir -p build
	$(PY) -m csnappy_jax.cli block -c -m snappy tests/data/urls.10K build/u.blk
	$(PY) -m csnappy_jax.cli block -d -m snappy build/u.blk build/u.blk.out
	cmp build/u.blk.out tests/data/urls.10K && echo "block_test passed"

bench:
	$(PY) bench.py

clean:
	$(MAKE) -C csrc clean
	rm -rf .pytest_cache build
