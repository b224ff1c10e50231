"""Multi-host / multi-device execution driver.

The reference is a single shared-memory process (SURVEY §2.3: OpenMP only, no
communication backend).  This framework scales the same computation over
several processes: ``jax.distributed`` bootstraps the N-process runtime, the
(rows, scp) mesh from parallel/mesh.py shards the fused AJI step (genome row
bands x protein shards, psum over NCCL on GPUs), and per-process results
are gathered so process 0 can write the CSV — the replacement for the
reference's ``omp barrier`` + shared-memory accumulation
(algorithm_impl.hpp:295-322).

Bootstrap contract: ``init_distributed()`` must run BEFORE anything touches a
JAX backend (jax.devices(), any computation, even jax.process_count()), or
the local single-process backend wins and ``jax.distributed.initialize``
can never take effect.  cli.run calls it first thing.

Launch interface (every process runs the same CLI command):
  PARFASTAAI_COORDINATOR=host:port   coordinator address (process 0's)
  PARFASTAAI_NUM_PROCESSES=N         total process count
  PARFASTAAI_PROCESS_ID=i            this process's rank
or any environment ``jax.distributed.initialize()`` auto-detects (SLURM,
GKE) signalled by JAX_COORDINATOR_ADDRESS / COORDINATOR_ADDRESS.  Each
process claims every GPU it can see, so several processes on one host each
need their own card through ``CUDA_VISIBLE_DEVICES``.
"""

from __future__ import annotations

import os

import numpy as np

_initialized = False


def init_distributed() -> bool:
    """Bootstrap the JAX distributed runtime when launched multi-process.

    Returns True when a multi-process runtime was initialized, False for
    plain single-process runs (no coordinator configured).  Idempotent.
    Call BEFORE any JAX backend use (see module docstring).
    """
    global _initialized
    if _initialized:
        return True
    coord = os.environ.get("PARFASTAAI_COORDINATOR")
    auto = (
        "JAX_COORDINATOR_ADDRESS" in os.environ
        or "COORDINATOR_ADDRESS" in os.environ
    )
    if coord is None and not auto:
        return False
    import jax

    if coord is not None:
        jax.distributed.initialize(
            coordinator_address=coord,
            num_processes=int(os.environ["PARFASTAAI_NUM_PROCESSES"]),
            process_id=int(os.environ["PARFASTAAI_PROCESS_ID"]),
        )
    else:
        # Launcher-managed environments (SLURM, GKE):
        # jax.distributed auto-detects coordinator/rank/world-size.
        jax.distributed.initialize()
    _initialized = True
    return True


def gather_to_host(x) -> np.ndarray:
    """Materialize a (possibly multi-process sharded) array on every host."""
    import jax

    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)


def broadcast_from_primary(value: int) -> int:
    """Agree on a host-side integer across processes (process 0's value wins).
    Used for the streamed-resume row count, which only the CSV-writing
    primary can read from disk."""
    import jax

    if jax.process_count() <= 1:
        return value
    from jax.experimental import multihost_utils

    out = multihost_utils.broadcast_one_to_all(
        np.asarray(value, dtype=np.int64)
    )
    return int(out)


def broadcast_pyobj(obj):
    """Ship one picklable object from the primary to every process.

    Single-process runs return ``obj`` unchanged.  Non-primary processes'
    ``obj`` is ignored (pass None).  Two collectives: an int64 length, then
    the pickled bytes as a uint8 array (broadcast_one_to_all requires every
    process to present the same shape)."""
    import jax

    if jax.process_count() <= 1:
        return obj
    import pickle

    from jax.experimental import multihost_utils as mhu

    if is_primary():
        data = np.frombuffer(
            pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL), np.uint8
        )
    else:
        data = np.zeros(0, np.uint8)
    n = int(mhu.broadcast_one_to_all(np.asarray(len(data), np.int64)))
    if len(data) != n:
        data = np.zeros(n, np.uint8)
    return pickle.loads(np.asarray(mhu.broadcast_one_to_all(data)).tobytes())


def broadcast_presence(presence, error=None, meta_only: bool = False):
    """Single-reader ETL: only the primary opened the SQLite database; ship
    its PresenceData (or its ETL failure) to every process.

    The reference opens the DB once — but it has exactly one process
    (scp_db.hpp:86-90).  At pod scale, re-running the multi-GB SQLite ETL on
    every host is N-times redundant: one host reads, and
    the presence tensors ride the collective fabric instead.  The 0/1
    presence tensor is bit-packed for the wire (8x fewer DCN bytes); T /
    widths / tetramer ids travel pickled (KBs).

    ``meta_only`` (primary's decision; the header carries it to everyone):
    skip the tensor broadcast entirely — non-primaries get a PresenceData
    whose ``m`` is a MetaOnlyM shape stub, and every process's presence is
    marked ``slab_broadcast = True`` so the mesh slab store ships each
    slab's packed bytes on demand instead (engine._mesh_slab_store).  This
    is the staged-mesh memory contract: non-primary host RSS stays
    O(T + one slab) instead of O(P*G*K), so genome capacity genuinely
    scales with host RAM x pod size.

    ``error``: the primary's ETL exception, if any — broadcast in place of
    the header so every process raises the same PFAAIError instead of the
    non-primaries deadlocking in a collective the primary never joins.
    Single-process runs return ``presence`` (or raise ``error``) directly.
    """
    import jax

    if jax.process_count() <= 1:
        if error is not None:
            raise error
        return presence
    from jax.experimental import multihost_utils as mhu

    primary = is_primary()
    header = None
    if primary:
        header = error if error is not None else {
            "meta": presence.meta,
            "shape": tuple(presence.m.shape),
            "t": presence.t,
            "widths": presence.widths,
            "tetramer_ids": presence.tetramer_ids,
            "meta_only": bool(meta_only),
        }
    header = broadcast_pyobj(header)
    if isinstance(header, BaseException):
        raise header
    if header.get("meta_only"):
        from ..etl.database import MetaOnlyM, PresenceData

        if primary:
            out_pres = presence  # keep the original (engine caches)
        else:
            out_pres = PresenceData(
                meta=header["meta"],
                m=MetaOnlyM(header["shape"]),
                t=header["t"],
                widths=header["widths"],
                tetramer_ids=header["tetramer_ids"],
            )
        out_pres.slab_broadcast = True
        return out_pres
    P, G, K = header["shape"]
    kb = (K + 7) // 8
    # Chunk the bit tensor along the protein axis: broadcast_one_to_all
    # device-puts its whole operand, so a single-shot broadcast of a
    # presence tensor near (or beyond) one HBM — exactly the staged-slab
    # scale — would OOM the chip before any compute.  Chunks are bounded by
    # PARFASTAAI_BCAST_CHUNK_BYTES (default 256 MiB of packed bits).
    import os

    chunk_bytes = int(
        float(os.environ.get("PARFASTAAI_BCAST_CHUNK_BYTES", 256 * 1024**2))
    )
    per_p = max(1, G * kb)
    p_step = max(1, min(P, chunk_bytes // per_p))
    if primary:
        out = None
    else:
        out = np.empty((P, G, kb), np.uint8)
    for p0 in range(0, P, p_step):
        p1 = min(P, p0 + p_step)
        if primary:
            chunk = np.packbits(
                np.ascontiguousarray(presence.m[p0:p1]), axis=-1
            )
        else:
            chunk = np.zeros((p1 - p0, G, kb), np.uint8)
        got = np.asarray(mhu.broadcast_one_to_all(chunk))
        if not primary:
            out[p0:p1] = got
    if primary:
        return presence  # keep the original (engine caches hang off it)
    from ..etl.database import PresenceData

    return PresenceData(
        meta=header["meta"],
        m=np.unpackbits(out, axis=-1)[..., :K],
        t=header["t"],
        widths=header["widths"],
        tetramer_ids=header["tetramer_ids"],
    )


def is_primary() -> bool:
    """True on the process that owns CSV/file output (reference semantics:
    one writer, src/main.cpp:133-175; everyone else only computes)."""
    import jax

    return jax.process_index() == 0
