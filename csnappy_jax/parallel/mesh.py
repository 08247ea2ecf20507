"""Mesh scale-out — the batched block codec, data-parallel over devices.

The reference is single-threaded C; its parallelism hook is format-level:
no back-reference ever crosses a 32 KiB block boundary
(csnappy_compress.c:75-87), so blocks are independent (SURVEY.md §2).  The
design is therefore:

  * split the blocks over the 1-D ``blocks`` mesh axis (shard_map), one
    equal shard per device;
  * each device runs the batched encode or decode on its shard, with no
    halo exchange;
  * all-gather the per-block compressed or decoded *lengths* (a small int32
    vector) so every device can compute the global in-order payload offsets
    — the distributed analog of the block container's length table
    (block_compressor.c:298-333);
  * payloads come back shard by shard and are assembled in block order on
    the host.

Each dispatch compiles under one jit; the collective is XLA's all_gather
over the mesh axis (NCCL between GPUs).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..errors import raise_for_code
from ..models import wire
from ..ops import batching, decode_jnp, encode_fused


def default_mesh(devices=None, n: int | None = None) -> Mesh:
    devs = list(devices if devices is not None else jax.devices())
    if n is not None:
        devs = devs[:n]
    return Mesh(np.asarray(devs), ("blocks",))


def _with_offsets(lens):
    all_lens = jax.lax.all_gather(lens, "blocks", tiled=True)
    return jnp.cumsum(all_lens) - all_lens      # identical on every device


@functools.lru_cache(maxsize=16)
def _compiled_shard_encode(mesh: Mesh):
    def body(d, l):
        comp, lens = encode_fused.encode_core(d, l)
        return comp, lens, _with_offsets(lens)

    return jax.jit(jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P("blocks", None), P("blocks")),
        out_specs=(P("blocks", None), P("blocks"), P()),
        check_vma=False,   # loop state starts replicated, becomes per-device
    ))


@functools.lru_cache(maxsize=16)
def _compiled_shard_decode(out_cap: int, mesh: Mesh):
    def body(c, l, dl):
        out, produced, status = decode_jnp.decode_batch(c, l, dl, out_cap=out_cap)
        return out, produced, status, _with_offsets(produced)

    return jax.jit(jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P("blocks", None), P("blocks"), P("blocks")),
        out_specs=(P("blocks", None), P("blocks"), P("blocks"), P()),
        check_vma=False,
    ))


def compress_sharded(data: bytes, mesh: Mesh | None = None, bs: int = wire.BLOCK_SIZE) -> bytes:
    """Whole-stream compress with blocks data-parallel over the mesh."""
    mesh = mesh or default_mesh()
    n_dev = mesh.devices.size
    buf = np.frombuffer(data, np.uint8)
    n = len(buf)
    out = bytearray(wire.varint_encode(n))
    if n == 0:
        return bytes(out)
    nb = (n + bs - 1) // bs
    BS = encode_fused.block_width(bs)
    ocap = wire.max_compressed_length(BS)
    fn = _compiled_shard_encode(mesh)
    sh_b = NamedSharding(mesh, P("blocks", None))
    sh_l = NamedSharding(mesh, P("blocks"))
    for start, stop, padded in batching.dispatches(nb, BS + ocap, n_dev):
        flat = np.zeros(((stop - start) * bs,), np.uint8)
        part = buf[start * bs : stop * bs]
        flat[: len(part)] = part
        pages = np.zeros((padded, BS), np.uint8)
        pages[: stop - start, :bs] = flat.reshape(-1, bs)
        blens = np.zeros((padded,), np.int32)
        blens[: stop - start] = bs
        if stop == nb:
            blens[stop - start - 1] = n - (nb - 1) * bs
        comp, lens, _ = fn(jax.device_put(pages, sh_b), jax.device_put(blens, sh_l))
        out += encode_fused.compact(np.asarray(comp)[: stop - start],
                                    np.asarray(lens)[: stop - start])
    return bytes(out)


def decompress_fragments_sharded(
    frags: list[bytes], out_lens: list[int], mesh: Mesh | None = None
) -> list[bytes]:
    """Decode independent headerless fragments data-parallel over the mesh."""
    mesh = mesh or default_mesh()
    n_dev = mesh.devices.size
    nb = len(frags)
    out_cap = decode_jnp.bucket(max(out_lens, default=0))
    width = decode_jnp.bucket(max((len(f) for f in frags), default=0))
    fn = _compiled_shard_decode(out_cap, mesh)
    sh_b = NamedSharding(mesh, P("blocks", None))
    sh_l = NamedSharding(mesh, P("blocks"))
    result = []
    for start, stop, padded in batching.dispatches(nb, width + out_cap, n_dev):
        batch = np.zeros((padded, width), np.uint8)
        clens = np.zeros((padded,), np.int32)
        # per-fragment dst_limit, so a fragment producing more than its
        # declared length is E_OUTPUT_OVERRUN
        dlims = np.zeros((padded,), np.int32)
        for j, i in enumerate(range(start, stop)):
            batch[j, : len(frags[i])] = np.frombuffer(frags[i], np.uint8)
            clens[j] = len(frags[i])
            dlims[j] = out_lens[i]
        out, produced, status, _ = fn(
            jax.device_put(batch, sh_b),
            jax.device_put(clens, sh_l),
            jax.device_put(dlims, sh_l),
        )
        out, produced, status = np.asarray(out), np.asarray(produced), np.asarray(status)
        for j, i in enumerate(range(start, stop)):
            raise_for_code(int(status[j]), f"fragment {i}")
            result.append(out[j, : produced[j]].tobytes())
    return result
