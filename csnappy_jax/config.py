"""Codec configuration — the reference's knob surface as one dataclass.

The reference exposes: compile-time macros (DEBUG, HAVE_BUILTIN_CTZ, arch
switches), one real runtime knob (``workmem_bytes_power_of_two``, 9..15,
csnappy_compress.c:484-488), getopt flags, and Kconfig choices (SURVEY.md §5
"config / flag system").  Here every tunable is explicit and serializable;
kernels treat each distinct config as a static compile key:

  * ``block_size``   — whole-stream fragment size (csnappy_compress.c:636).
  * ``page_size``    — block-container page size (zram parity, patch :1346).
  * ``hash_bits``    — candidate hash width.  The analog of the reference's
    workmem knob: more bits = fewer collisions = better ratio.  The fused
    encoder's sort-based matcher has no table, so this defaults to the
    userspace reference's 16 (csnappy.h:13) and may range 10..16.
  * ``backend``      — jax | py | native.
  * ``debug_checks`` — every jax-path result is cross-checked against the
    pure-Python oracle (the sanitizer mode; SURVEY.md §5 race-detection
    analog).  Env default: CSNAPPY_DEBUG=1.
"""
from __future__ import annotations

import os
import pathlib
from dataclasses import dataclass, field


@dataclass(frozen=True)
class CodecConfig:
    block_size: int = 32768        # fragment size; ≤ 32768, multiple of 1024
    page_size: int = 4096          # block-container page size (zram parity)
    hash_bits: int = 16            # candidate hash width, 10..16 (py/native
                                   # models; the fused sort matcher is exact)
    backend: str = "jax"           # jax | py | native
    mesh_axis: str = "blocks"      # data-parallel axis name for mesh paths
    debug_checks: bool = field(
        default_factory=lambda: bool(os.environ.get("CSNAPPY_DEBUG"))
    )

    def __post_init__(self):
        if not 1024 <= self.block_size <= 32768 or self.block_size % 1024:
            raise ValueError("block_size must be in [1024, 32768], multiple of 1024")
        if not 1024 <= self.page_size or self.page_size % 1024:
            raise ValueError("page_size must be a multiple of 1024 >= 1024")
        if not 10 <= self.hash_bits <= 16:
            raise ValueError("hash_bits must be in [10, 16]")
        if self.backend not in ("jax", "py", "native"):
            raise ValueError(f"unknown backend {self.backend!r}")


DEFAULT = CodecConfig()


def use_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses it and
    nothing else is set.  Otherwise the cache is ``.jax_cache`` in the
    checkout, a fixed path, so later runs find what earlier ones compiled.
    """
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    import jax

    path = str(pathlib.Path(__file__).resolve().parents[1] / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
