"""Multi-host scale-out — jax.distributed + per-host I/O + in-order gather.

BASELINE config 5 / SURVEY.md §5 "distributed communication backend": the
codec's only cross-device traffic is (a) the all-gather of per-block
compressed *lengths* (a small int32 vector, XLA's collective within and
across hosts) and (b) the in-order assembly of
variable-length payloads, which happens at the storage layer: every host
learns the global offset table from (a) and writes its own blocks' payloads
at their final positions — the distributed analog of the block container's
length table (block_compressor.c:298-333), with no payload shuffle at all.

Usage on a cluster: one process per host, ``init()`` with the coordinator
address, feed each process its slice of blocks.  The 2-process loopback
selftest (``python -m csnappy_jax.parallel.multihost --worker ...``) runs
the identical code path on CPU devices.
"""
from __future__ import annotations

import numpy as np


def init(coordinator_address: str, num_processes: int, process_id: int) -> None:
    """jax.distributed bring-up (idempotent per process)."""
    import jax

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(axis: str = "blocks"):
    from jax.sharding import Mesh
    import jax

    return Mesh(np.asarray(jax.devices()), (axis,))


def compress_blocks_multihost(local_pages: np.ndarray, local_lens: np.ndarray, mesh):
    """Compress this host's blocks within a global mesh computation.

    local_pages: uint8[nb_local, bs] — this process's contiguous slice of
    the global block sequence (equal nb_local per process).  Returns
    (comp_local uint8[nb_local, ocap], clens_local, global_offsets) where
    global_offsets[i] is the payload file offset of global block i — every
    host returns the same offsets (all-gather), so each writes its own
    payloads in place: the in-order gather.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..ops import encode_fused

    sh_b = NamedSharding(mesh, P("blocks", None))
    sh_l = NamedSharding(mesh, P("blocks"))
    garr = jax.make_array_from_process_local_data(sh_b, np.asarray(local_pages, np.uint8))
    glens = jax.make_array_from_process_local_data(sh_l, local_lens.astype(np.int32))

    # shard_map over the *global* mesh: local batched encode + length
    # all-gather (XLA inserts the collective across processes)
    def body(p, l):
        comp, clens = encode_fused.encode_core(p, l)
        all_lens = jax.lax.all_gather(clens, "blocks", tiled=True)
        return comp, clens, jnp.cumsum(all_lens) - all_lens

    fn = jax.jit(
        jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(P("blocks", None), P("blocks")),
            out_specs=(P("blocks", None), P("blocks"), P()),
            check_vma=False,
        )
    )
    comp, clens, offsets = fn(garr, glens)
    # this host's addressable shards, in block order
    local_comp = np.concatenate([np.asarray(s.data) for s in comp.addressable_shards])
    local_clens = np.concatenate(
        [np.asarray(s.data).reshape(-1) for s in clens.addressable_shards]
    )
    return local_comp, local_clens, np.asarray(offsets.addressable_shards[0].data)


def _worker(rank: int, nprocs: int, port: int, out_path: str, n_bytes: int) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    init(f"localhost:{port}", nprocs, rank)
    import pathlib

    data = (
        pathlib.Path(__file__).parents[2] / "tests" / "data" / "urls.10K"
    ).read_bytes()[:n_bytes]
    bs = 4096
    nb = (len(data) + bs - 1) // bs
    nb += (-nb) % nprocs                      # pad to equal shards
    pages = np.zeros((nb, bs), np.uint8)
    pages.reshape(-1)[: len(data)] = np.frombuffer(data, np.uint8)
    lens = np.zeros((nb,), np.int32)
    full = (len(data) + bs - 1) // bs
    lens[:full] = bs
    lens[full - 1] = len(data) - (full - 1) * bs
    per = nb // nprocs
    mesh = global_mesh()
    lc, ll, offs = compress_blocks_multihost(
        pages[rank * per : (rank + 1) * per], lens[rank * per : (rank + 1) * per], mesh
    )
    np.savez(out_path, comp=lc, clens=ll, offsets=offs, nb=nb, per=per)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--nbytes", type=int, default=65536)
    a = ap.parse_args(argv)
    _worker(a.rank, a.nprocs, a.port, a.out, a.nbytes)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
