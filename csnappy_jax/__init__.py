"""csnappy_jax — a Snappy codec in JAX.

A from-scratch JAX/XLA implementation of the Snappy compression format with
the full capability surface of the C reference (zeevt/csnappy, see
SURVEY.md): whole-stream and headerless-fragment APIs, safe bounds-checked
decode with the reference's error-code contract, zram-style batched block
mode with a length-table container, CLI/selftest harness, and data-parallel
scale-out over device meshes.
"""
from .errors import (
    E_DATA_MALFORMED,
    E_HEADER_BAD,
    E_INPUT_NOT_CONSUMED,
    E_OK,
    E_OUTPUT_INSUF,
    E_OUTPUT_OVERRUN,
    E_TOO_LARGE,
    SnappyError,
)
from .models import wire

__version__ = "0.1.0"
CSNAPPY_COMPAT_VERSION = 5  # API-parity version (csnappy.h:11)

__all__ = [
    "wire",
    "SnappyError",
    "E_OK",
    "E_HEADER_BAD",
    "E_OUTPUT_INSUF",
    "E_OUTPUT_OVERRUN",
    "E_INPUT_NOT_CONSUMED",
    "E_DATA_MALFORMED",
    "E_TOO_LARGE",
]
