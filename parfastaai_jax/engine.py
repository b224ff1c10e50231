"""The AJI compute engine: device intersection counts + exact f64 finish.

Replaces the reference's Phase 3/4 (ParFAAIImpl::computeJAC / computeAJI,
algorithm_impl.hpp:222-329).  The per-pair, per-protein Jaccard is

    J_p(A, B) = cnt / (T[p, A] + T[p, B] - cnt)        (cnt > 0 only)
    S(A, B)   = sum over proteins with cnt > 0, ascending protein order
    N(A, B)   = count of such proteins
    AJI(A, B) = S / N                                   (NaN when N == 0)

Two paths:

* ``compute`` (exact, CLI default): intersection counts are integers and
  computed exactly on device (int8 tensor-core matmul); the (P, n_pairs)
  count matrix is the *single* device->host transfer (int16 when counts
  fit), and the O(|P|) ~ 80-flop-per-pair finish runs on host in f64 with a sequential
  ascending-protein loop — vectorized across pairs, sequential across
  proteins, exactly the reference's E-block walk order (E sorted by
  (G_A, G_B, proteinIndex), interface.hpp:103), satisfying the tests'
  bit-for-bit double equality (tests/pfaai_tests.cpp:355-454).

* ``compute_fast`` (production screening): the whole pipeline fused on device
  in f32 (ops/fused.py), transferring only per-pair results.  ~1e-7
  relative error vs exact; orders of magnitude less host traffic.
"""

from __future__ import annotations

import os

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .etl.database import PresenceData
from .modes import PairSpace
from .ops.fused import fused_sn, fused_sn_block, pair_counts_device
from .types import JacResult


def jaccard_finish(
    counts: np.ndarray,  # integer (P, n_pairs)
    denom_ta: np.ndarray,  # int (P, n_pairs) — T[p, denom_a]
    denom_tb: np.ndarray,  # int (P, n_pairs) — T[p, denom_b]
) -> tuple[np.ndarray, np.ndarray]:
    """Sequential ascending-protein f64 accumulation of (S, N) per pair.

    Uses the native C++/OpenMP kernel when available (native/pfaai_native.cpp
    — identical f64 operation order, so bit-for-bit equal), falling back to
    the vectorized NumPy loop."""
    from .native import native_jaccard_finish

    res = native_jaccard_finish(counts, denom_ta, denom_tb)
    if res is not None:
        return res
    P, n = counts.shape
    s = np.zeros(n, dtype=np.float64)
    nacc = np.zeros(n, dtype=np.int32)
    for p in range(P):
        c = counts[p]
        mask = c > 0
        if not mask.any():
            continue
        cm = c[mask].astype(np.float64)
        dm = (denom_ta[p][mask] + denom_tb[p][mask] - c[mask]).astype(np.float64)
        s[mask] += cm / dm
        nacc += mask
    return s, nacc


# Problems of at most this many int8 MACs (P * G * G * K) count on host
# BLAS: below it a device round trip costs more than the host's f64 Gram.
# The threshold was set on the CPU backend (~2 s of host BLAS); the
# crossover on a GPU host is not measured yet.
# PARFASTAAI_HOST_WORK_LIMIT=<MACs> overrides it; PARFASTAAI_FORCE_DEVICE=1
# disables the host fallbacks entirely.
HOST_WORK_LIMIT = int(4e9)


def _use_host(presence: PresenceData) -> bool:
    """True when the whole problem is small enough for host BLAS."""
    if os.environ.get("PARFASTAAI_FORCE_DEVICE"):
        return False
    P, G, K = presence.m.shape
    limit = os.environ.get("PARFASTAAI_HOST_WORK_LIMIT")
    limit = HOST_WORK_LIMIT if limit is None else int(float(limit))
    return P * G * G * K <= limit


def _unpack_bits(bits: jax.Array, k: int) -> jax.Array:
    """(…, ceil(k/8)) uint8 big-bit-order (np.packbits layout) -> (…, k) int8."""
    import jax.numpy as jnp

    shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8)
    x = (bits[..., :, None] >> shifts) & jnp.uint8(1)
    return x.reshape(*bits.shape[:-1], bits.shape[-1] * 8)[..., :k].astype(
        jnp.int8
    )


_unpack_bits_device = partial(jax.jit, static_argnames=("k",))(_unpack_bits)


def upload_presence(m_np: np.ndarray) -> jax.Array:
    """Ship a presence tensor to the device as packed bits, unpack on device.

    The 0/1 int8 tensor is the largest host->device transfer of every device
    path (P*G*K bytes); host-side np.packbits cuts the bytes 8x and one
    jitted device op expands them back to int8.  Whether that pays on a
    PCIe-attached card is not measured yet.  On CPU the plain transfer is
    free, so packing is skipped."""
    import jax

    if jax.default_backend() == "cpu":
        return jnp.asarray(m_np)
    k = m_np.shape[-1]
    bits = np.packbits(np.ascontiguousarray(m_np), axis=-1)
    return _unpack_bits_device(jnp.asarray(bits), k)


def _is_triu_pairs(pairs: PairSpace, g: int) -> bool:
    """True when the pair slots are exactly the row-major upper triangle of
    a g x g space (the all-vs-all layout, modes.all_vs_all)."""
    if pairs.n_pairs != g * (g - 1) // 2 or g < 2:
        return False
    a, b = np.triu_indices(g, k=1)
    return np.array_equal(pairs.db_a, a) and np.array_equal(pairs.db_b, b)


def _is_rect_pairs(pairs: PairSpace) -> bool:
    """True when the pair slots are the full row-major rows x cols product of
    the CSV axes (the two-database layout, modes.query_target) — including
    that the denominator columns factor into the per-row / per-column vectors
    (they do for both compat settings; see PairSpace.row_denom_ids)."""
    nr, nc = len(pairs.row_db_ids), len(pairs.col_db_ids)
    if pairs.n_pairs != nr * nc or pairs.n_pairs == 0:
        return False
    return (
        np.array_equal(pairs.db_a, np.repeat(pairs.row_db_ids, nc))
        and np.array_equal(pairs.db_b, np.tile(pairs.col_db_ids, nr))
        and np.array_equal(pairs.denom_a, np.repeat(pairs.row_denom_ids, nc))
        and np.array_equal(pairs.denom_b, np.tile(pairs.col_denom_ids, nr))
    )


@jax.jit
def _mask_aji(s: jax.Array, n: jax.Array) -> jax.Array:
    """Finish one streamed block ON device: AJI = S/N with no-shared-protein
    cells (n == 0) forced to 0 (the reference leaves those CSV cells
    untouched => 0, src/main.cpp:133-175).  Masking here means only this one
    f32 array crosses to the host per block — half the bytes of shipping
    (aji, n) separately."""
    return jnp.where(n == 0, jnp.float32(0), s / n.astype(jnp.float32))


@jax.jit
def _gather_triu(s_mat: jax.Array, n_mat: jax.Array):
    """Gather the row-major upper triangle of (g, g) matrices with indices
    generated on device (searchsorted over row offsets — no host->device
    index upload)."""
    g = s_mat.shape[0]
    q = jnp.arange(g * (g - 1) // 2, dtype=jnp.int32)
    row_len = (g - 1) - jnp.arange(g, dtype=jnp.int32)
    starts = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(row_len[:-1], dtype=jnp.int32)]
    )
    a = (
        jnp.searchsorted(starts, q, side="right").astype(jnp.int32) - 1
    )
    b = q - starts[a] + a + 1
    return s_mat[a, b], n_mat[a, b]


def _pair_counts_host(
    m: np.ndarray, db_a: np.ndarray, db_b: np.ndarray
) -> np.ndarray:
    """Exact counts on host via BLAS f64 batched matmul (exact: counts <= K
    << 2^53)."""
    mf = m.astype(np.float64)
    cnt = mf @ mf.transpose(0, 2, 1)
    return np.rint(cnt[:, db_a, db_b]).astype(np.int32)


def compute(presence: PresenceData, pairs: PairSpace) -> JacResult:
    """Exact path: integer intersection counts + host f64 finish (bit-parity).

    Counts come from the device int8 Gram matmul — or, for parity-scale inputs
    under HOST_WORK_LIMIT MACs, the identical computation on host BLAS
    (integer counts are exact on any backend, so the results are
    indistinguishable)."""
    # Counts are bounded by max(T); use int16 when safe to halve the one
    # device->host transfer.
    out_dtype = _count_wire_dtype(presence)
    if _use_host(presence):
        counts = _pair_counts_host(presence.m, pairs.db_a, pairs.db_b)
    else:
        counts = np.asarray(
            pair_counts_device(
                upload_presence(presence.m),
                jnp.asarray(pairs.db_a),
                jnp.asarray(pairs.db_b),
                out_dtype=out_dtype,
            )
        )
    # int32 throughout: the denominator sum fits int32 (T < 160000) and the
    # native finish consumes int32 gathers and int16/int32 counts directly —
    # the old int64 upcast allocated two (P, n_pairs) int64 temporaries plus
    # two int32 conversion copies, ~16 GB of avoidable churn at G=4096.
    t = presence.t
    s, n = jaccard_finish(counts, t[:, pairs.denom_a], t[:, pairs.denom_b])
    return JacResult(
        genome_a=pairs.jac_a.astype(np.int32),
        genome_b=pairs.jac_b.astype(np.int32),
        s=s,
        n=n,
    )


def _resume_point(out_path: str, header: str, band: int) -> int:
    """Rows already complete in a partial streamed CSV, rounded down to a
    band boundary; truncates the file to exactly those rows.  Returns 0 (and
    leaves rewriting to the caller) when the file is absent or its header
    does not match this run's column set."""
    import os

    if not os.path.exists(out_path):
        return 0
    rows = 0
    keep_bytes = 0
    with open(out_path, "rb") as fp:
        first = fp.readline()
        if not first.endswith(b"\n") or first.decode() != header:
            return 0
        offset = len(first)
        for line in fp:
            if not line.endswith(b"\n"):
                break  # trailing partial write from the interrupted run
            offset += len(line)
            rows += 1
            if rows % band == 0:
                keep_bytes = offset  # only band-aligned prefixes are resumable
    rows -= rows % band
    if rows == 0:
        return 0
    with open(out_path, "r+b") as fp:
        fp.truncate(keep_bytes)
    return rows


def jaccard_finish_block(
    counts: np.ndarray,  # integer (P, A, B)
    ta: np.ndarray,  # int (P, A) — T[p, row_denom_ids]
    tb: np.ndarray,  # int (P, B) — T[p, col_denom_ids]
) -> tuple[np.ndarray, np.ndarray]:
    """Banded-block twin of jaccard_finish: (S, N) for an (A, B) output block
    with per-axis denominator columns — no (P, A*B) gather materializes.
    Same ascending-protein f64 accumulation per cell, so bit-for-bit equal to
    the per-pair finish.  Native C++/OpenMP when available."""
    from .native import native_jaccard_finish_block

    res = native_jaccard_finish_block(counts, ta, tb)
    if res is not None:
        return res
    P, A, B = counts.shape
    s = np.zeros((A, B), dtype=np.float64)
    n = np.zeros((A, B), dtype=np.int32)
    ta64 = ta.astype(np.float64)
    tb64 = tb.astype(np.float64)
    for p in range(P):
        mask = counts[p] > 0
        if not mask.any():
            continue
        c = counts[p].astype(np.float64)
        denom = ta64[p][:, None] + tb64[p][None, :] - c
        with np.errstate(divide="ignore", invalid="ignore"):
            s += np.where(mask, c / denom, 0.0)
        n += mask
    return s, n


def _device_buckets(presence: PresenceData):
    """Uploaded width buckets of one PresenceData, shared by the fused-S/N
    and integer-count block engines — the presence tensor crosses the wire
    once per backend no matter how many engines run on it."""
    import jax

    cache = getattr(presence, "_device_bucket_cache", None)
    if cache is None:
        cache = {}
        presence._device_bucket_cache = cache
    key = jax.default_backend()
    if key not in cache:
        from .etl.database import bucketize_presence

        cache[key] = [
            (idx, upload_presence(m_b), jnp.asarray(t_b))
            for idx, m_b, t_b in bucketize_presence(presence)
        ]
    return cache[key]


def _hbm_budget() -> int | None:
    """Device-memory budget for presence residency decisions.

    PARFASTAAI_HBM_BYTES overrides; otherwise 75% of the device's reported
    memory limit (leaving room for result blocks, double buffering and XLA
    scratch).  None on the CPU backend, whose "device" is host memory —
    callers then keep the resident engines.  An accelerator that reports no
    limit is an error: its memory is not guessed."""
    import os

    env = os.environ.get("PARFASTAAI_HBM_BYTES")
    if env:
        return int(float(env))
    import jax

    dev = jax.local_devices()[0]
    if dev.platform == "cpu":
        return None
    stats = dev.memory_stats() or {}
    if not stats.get("bytes_limit"):
        raise RuntimeError(
            f"{dev.device_kind} reports no memory limit; set "
            "PARFASTAAI_HBM_BYTES to the device-memory budget in bytes"
        )
    return int(stats["bytes_limit"] * 0.75)


def _slab_cap() -> float:
    """Bytes the slab LRUs may hold: 0.75 of the device budget, large enough
    for a full row-set + col-set of _slab_target_bytes sub-slabs without
    churn; the remaining quarter covers the evicted generation async
    dispatch keeps alive plus the unpack temps.  Unbounded on the CPU
    backend, whose slabs live in host memory."""
    budget = _hbm_budget()
    return float("inf") if budget is None else budget * 0.75


def presence_device_bytes(presence: PresenceData) -> int:
    """HBM bytes the RESIDENT block engines would hold: the width-bucketed
    int8 presence slices of _device_buckets (sum of Pb * G * Kb)."""
    from .etl.database import bucket_bounds

    _, bounds = bucket_bounds(presence.widths)
    g = presence.m.shape[1]
    return sum((i - k) * g * kb for k, i, kb in bounds)


def _staged_override(staged: bool | None) -> bool | None:
    """Explicit-arg / PARFASTAAI_STAGED tri-state resolution shared by
    _use_staged and _use_staged_mesh; None means 'decide from the budget'.
    "0"/"false"/"no" force resident, any other non-empty value forces
    staged (plain truthiness would read PARFASTAAI_STAGED=0 as ON)."""
    import os

    if staged is not None:
        return staged
    env = os.environ.get("PARFASTAAI_STAGED")
    if env is not None and env != "":
        return env.lower() not in ("0", "false", "no")
    return None


def _use_staged(presence: PresenceData, staged: bool | None = None) -> bool:
    """Resolve the staged-vs-resident choice: explicit caller/CLI setting,
    then PARFASTAAI_STAGED, then automatic (presence exceeds the device
    budget when the backend reports one)."""
    override = _staged_override(staged)
    if override is not None:
        return override
    budget = _hbm_budget()
    return budget is not None and presence_device_bytes(presence) > budget


def _slab_target_bytes() -> int:
    """Upper bound on one staged slab's device bytes (PARFASTAAI_SLAB_BYTES
    overrides).  Sized several times below the LRU cap so a full slab
    generation — the current block's row+col slabs, the previous
    generation async dispatch still holds alive, and the in-flight
    unpack temp — fits HBM with headroom: the first >HBM run shipped
    whole-P 4.4 GiB slabs and ResourceExhausted'd from exactly that
    pile-up."""
    import os

    env = os.environ.get("PARFASTAAI_SLAB_BYTES")
    if env:
        return int(float(env))
    budget = _hbm_budget()
    if budget is None:
        return 2 << 30
    return min(2 << 30, max(256 << 20, budget // 6))


def _split_plan(plan, n_ids: int):
    """Subdivide each width bucket's protein list so no staged slab exceeds
    _slab_target_bytes at ``n_ids`` genomes: yields (bucket_i, p_chunk_i,
    protein_idx, kb).  Counts are integer-exact under any protein split;
    the f32 S accumulation order changes only at bucket granularity it
    already changed at."""
    target = _slab_target_bytes()
    for bi, (idx, kb) in enumerate(plan):
        # Largest chunk length that stays under target (floor, so every
        # chunk is bounded — ceil-dividing the count lets array_split's
        # larger chunks overshoot).
        chunk_len = max(1, target // max(1, n_ids * kb))
        n_pc = max(1, -(-len(idx) // chunk_len))
        for pci, idx_c in enumerate(np.array_split(idx, n_pc)):
            if len(idx_c):
                yield bi, pci, idx_c, kb


def _slab_store(presence: PresenceData):
    """Per-backend LRU of device-resident presence slabs, shared by the
    staged block and count engines.

    ``fetch(bucket_i, idx, kb, ids)`` returns the device int8 slab
    (len(idx), len(ids), kb) for width-bucket ``bucket_i`` (proteins ``idx``
    of presence.m, contraction width ``kb``), gathering from host and
    shipping bit-packed (engine.upload_presence) on miss.  Cached bytes are
    bounded by 75% of _hbm_budget (the rest covers async dispatch's
    in-flight evicted generation + unpack temps); the two live slabs of the
    current block are never evicted.  Slabs are protein-subdivided to
    _slab_target_bytes (engine._split_plan), so a band's full row+col slab
    set fits the cap and is reused across all its column chunks; for
    symmetric problems cached column slabs re-serve as later row bands
    while the budget lasts."""
    import jax

    stores = getattr(presence, "_slab_store_cache", None)
    if stores is None:
        stores = {}
        presence._slab_store_cache = stores
    backend = jax.default_backend()
    if backend not in stores:
        from collections import OrderedDict

        slabs: OrderedDict = OrderedDict()
        state = {"bytes": 0}
        cap = _slab_cap()

        counters = {"uploaded": 0}

        def fetch(bucket_i: int, idx: np.ndarray, kb: int, ids: np.ndarray):
            key = (bucket_i, ids.tobytes())
            hit = slabs.get(key)
            if hit is not None:
                slabs.move_to_end(key)
                return hit[0]
            nb = len(idx) * len(ids) * kb  # int8: elements == bytes
            # Evict BEFORE uploading: with eviction after, the cap can be
            # transiently exceeded by a whole slab right when HBM is
            # tightest.  len > 1 keeps the current block's other live slab
            # (always the most recently fetched entry).
            while state["bytes"] + nb > cap and len(slabs) > 1:
                _, (_, old_bytes) = slabs.popitem(last=False)
                state["bytes"] -= old_bytes
            # Slab-sized host gather only — never a full-G bucket copy, and
            # only the bucket's own K columns (np.ix_ over (idx, ids) alone
            # would copy the tensor's FULL width first: a narrow bucket of a
            # wide tensor would gather hundreds of times the slab size).
            # kb is bucket_bounds-padded and may exceed the tensor's own
            # width: gather into a zero slab so the device never pads (a
            # device-side pad materializes a copy of the whole slab).
            kw = min(kb, presence.m.shape[2])
            if kb == kw:
                slab_np = np.ascontiguousarray(
                    presence.m[idx[:, None], ids[None, :], :kw]
                )
            else:
                slab_np = np.zeros((len(idx), len(ids), kb), presence.m.dtype)
                slab_np[:, :, :kw] = presence.m[idx[:, None], ids[None, :], :kw]
            slab = upload_presence(slab_np)
            slabs[key] = (slab, nb)
            state["bytes"] += nb
            counters["uploaded"] += nb
            return slab

        fetch.uploaded_bytes = lambda: counters["uploaded"]
        stores[backend] = fetch
    return stores[backend]


# Jitted sharded-unpack programs, memoized per (k, sharding): a fresh
# jax.jit per slab fetch would re-trace (and, without the persistent compile
# cache, re-compile) the same unpack on every staged-mesh slab miss.
# Shardings hash by (mesh, spec, memory kind), so same-mesh fetches share
# one program.
_sharded_unpack_cache: dict = {}


def upload_presence_sharded(m_np: np.ndarray, sharding) -> jax.Array:
    """upload_presence for a mesh-sharded destination: ship packed bits with
    the target sharding (the spec's genome/protein axes split host-side, the
    K axis stays whole), unpack on device under the same sharding.  On CPU
    (tests / virtual meshes) the plain sharded transfer is free, so packing
    is skipped — same rule as upload_presence."""
    if jax.default_backend() == "cpu":
        return jax.device_put(jnp.asarray(m_np), sharding)
    k = m_np.shape[-1]
    bits = np.packbits(np.ascontiguousarray(m_np), axis=-1)
    bd = jax.device_put(bits, sharding)  # K axis is unsharded in every spec
    key = (k, sharding)
    unpack = _sharded_unpack_cache.get(key)
    if unpack is None:
        unpack = jax.jit(partial(_unpack_bits, k=k), out_shardings=sharding)
        _sharded_unpack_cache[key] = unpack
    return unpack(bd)


def _use_staged_mesh(
    presence: PresenceData, n_scp: int, staged: bool | None = None
) -> bool:
    """Staged-vs-resident choice for MESH paths: the resident mesh engine
    shards the presence tensor over the ``scp`` axis only (genome axis
    replicated), so the per-device residency is 1/n_scp of the single-device
    figure — the auto threshold scales accordingly."""
    override = _staged_override(staged)
    if override is not None:
        return override
    budget = _hbm_budget()
    return (
        budget is not None
        and presence_device_bytes(presence) // n_scp > budget
    )


def _mesh_key(mesh) -> tuple:
    """Cache-key identity of a device mesh: backend + shape + the exact
    device assignment.  Device ids matter — a same-shape Mesh over different
    devices must not reuse programs/slabs sharded for the first mesh.
    Single source for every mesh-keyed cache below."""
    import jax

    return (
        jax.default_backend(),
        tuple(sorted(mesh.shape.items())),
        tuple(d.id for d in mesh.devices.flat),
    )


def _mesh_slab_store(presence: PresenceData, mesh):
    """Mesh twin of _slab_store: presence slabs live SHARDED over the
    (rows, scp) mesh, so cached capacity — and therefore genome capacity —
    scales with the device count instead of capping at one device's memory
    (the reference's own memory-batching intent is
    doc/pfaai_algorithm.tex:218-224).

    ``fetch(key, idx, kb, ids, kind)`` returns the device int8 slab
    (pp, len(ids), kb) for proteins ``idx`` (padded to pp, a multiple of the
    scp axis — zero proteins are inert: cnt == 0 -> j == 0, n += 0) and
    genomes ``ids``:

    * kind='row': genome axis sharded over ``rows`` (each device holds its
      band shard) — per-device bytes are nb / (n_rows * n_scp);
    * kind='col': genome axis replicated over ``rows`` — per-device bytes
      are nb / n_scp.

    The LRU accounts PER-DEVICE bytes against the same 0.75-budget cap as
    the single-device store; row and col slabs of one genome set are
    distinct cache entries (their shardings differ)."""
    import jax

    stores = getattr(presence, "_mesh_slab_store_cache", None)
    if stores is None:
        stores = {}
        presence._mesh_slab_store_cache = stores
    from jax.sharding import NamedSharding, PartitionSpec as Spec

    store_key = _mesh_key(mesh)
    if store_key in stores:
        return stores[store_key]
    from collections import OrderedDict

    n_rows = mesh.shape["rows"]
    n_scp = mesh.shape.get("scp", 1)
    row_sh = NamedSharding(mesh, Spec("scp", "rows", None))
    col_sh = NamedSharding(mesh, Spec("scp", None, None))
    slabs: OrderedDict = OrderedDict()
    state = {"bytes": 0}
    cap = _slab_cap()

    def fetch(key, idx: np.ndarray, kb: int, ids: np.ndarray, kind: str):
        full_key = (kind, key, ids.tobytes())
        hit = slabs.get(full_key)
        if hit is not None:
            slabs.move_to_end(full_key)
            return hit[0]
        pp = -(-len(idx) // n_scp) * n_scp
        per_dev = pp * len(ids) * kb // (
            n_scp * (n_rows if kind == "row" else 1)
        )
        while state["bytes"] + per_dev > cap and len(slabs) > 1:
            _, (_, old_bytes) = slabs.popitem(last=False)
            state["bytes"] -= old_bytes
        kw = min(kb, presence.m.shape[2])
        from .parallel.distributed import is_primary

        primary = is_primary()
        if primary or not getattr(presence, "slab_broadcast", False):
            slab_np = np.zeros((pp, len(ids), kb), np.uint8)
            slab_np[: len(idx), :, :kw] = presence.m[
                idx[:, None], ids[None, :], :kw
            ]
        else:
            slab_np = None
        if getattr(presence, "slab_broadcast", False) and (
            jax.process_count() > 1
        ):
            # Meta-only multi-process mode (broadcast_presence meta_only):
            # the primary is the only process holding tensor bytes — ship
            # THIS slab's packed bits to everyone, so every process can
            # device_put its addressable shards.  All processes fetch in
            # the same deterministic block order with identical LRU state,
            # so the broadcast sequences line up.  Non-primary transient
            # memory is O(one slab) — this is what keeps host RSS flat
            # while genome capacity scales with the process count.
            from jax.experimental import multihost_utils as mhu

            kbp = -(-kb // 8)
            if primary:
                packed = np.packbits(slab_np, axis=-1)
            else:
                packed = np.zeros((pp, len(ids), kbp), np.uint8)
            got = np.asarray(mhu.broadcast_one_to_all(packed))
            if not primary:
                slab_np = np.unpackbits(got, axis=-1)[:, :, :kb]
        slab = upload_presence_sharded(
            slab_np, row_sh if kind == "row" else col_sh
        )
        slabs[full_key] = (slab, per_dev)
        state["bytes"] += per_dev
        return slab

    stores[store_key] = fetch
    return fetch


def _staged_mesh_block_engine(presence: PresenceData, mesh):
    """Staged (S, N) block engine over a (rows, scp) mesh: the streamed-mesh
    path's slab-fed twin of _staged_block_engine.  Each block's genome slabs
    are gathered host-side, shipped bit-packed ALREADY SHARDED (row slabs
    band-sharded over ``rows``, column slabs replicated; protein chunks
    sharded over ``scp``), and the per-device block (ops.fused.fused_sn_block)
    computes its row shard with a psum merge over scp — device
    residency is O(slab / mesh), so genome capacity scales with both host
    RAM and the device count.

    Same ``block_sn(rids, cids, drids, dcids, nb, nc) -> (s, n)`` contract
    as the other block engines; callers must pass len(rids) divisible by the
    rows axis (compute_streamed's mesh branch rounds the band up)."""
    import jax

    cache = getattr(presence, "_staged_mesh_engine_cache", None)
    if cache is None:
        cache = {}
        presence._staged_mesh_engine_cache = cache
    key = _mesh_key(mesh)
    if key in cache:
        return cache[key]

    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as Spec

    from .etl.database import bucket_bounds

    order, bounds = bucket_bounds(presence.widths)
    plan = [(order[k:i], kb) for k, i, kb in bounds]
    fetch = _mesh_slab_store(presence, mesh)
    n_scp = mesh.shape.get("scp", 1)
    t_row_sh = NamedSharding(mesh, Spec("scp", "rows"))
    t_col_sh = NamedSharding(mesh, Spec("scp", None))

    @jax.jit
    def slab_sn(ma, mb, ta, tb):
        def body(ma_l, mb_l, ta_l, tb_l):
            s, n = fused_sn_block(
                ma_l, mb_l, ta_l, tb_l, vma_axes=("rows", "scp")
            )
            return jax.lax.psum(s, "scp"), jax.lax.psum(n, "scp")

        return shard_map(
            body,
            mesh=mesh,
            in_specs=(
                Spec("scp", "rows", None),
                Spec("scp", None, None),
                Spec("scp", "rows"),
                Spec("scp", None),
            ),
            out_specs=(Spec("rows", None), Spec("rows", None)),
        )(ma, mb, ta, tb)

    def block_sn(rids, cids, drids, dcids, nb, nc):
        rids = np.asarray(rids)
        cids = np.asarray(cids)
        drids = np.asarray(drids)
        dcids = np.asarray(dcids)
        s = n = None
        for bi, pci, idx, kb in _split_plan(plan, max(len(rids), len(cids))):
            ma = fetch((bi, pci), idx, kb, rids, "row")
            mb = fetch((bi, pci), idx, kb, cids, "col")
            pp = ma.shape[0]
            ta_np = np.zeros((pp, len(drids)), presence.t.dtype)
            ta_np[: len(idx)] = presence.t[np.ix_(idx, drids)]
            tb_np = np.zeros((pp, len(dcids)), presence.t.dtype)
            tb_np[: len(idx)] = presence.t[np.ix_(idx, dcids)]
            ta = jax.device_put(ta_np, t_row_sh)
            tb = jax.device_put(tb_np, t_col_sh)
            s_b, n_b = slab_sn(ma, mb, ta, tb)
            s = s_b if s is None else s + s_b
            n = n_b if n is None else n + n_b
        return s, n

    cache[key] = block_sn
    return block_sn


def _staged_block_engine(presence: PresenceData):
    """Banded (S, N) block engine for presence tensors LARGER THAN ONE HBM.

    The resident engine (_bucket_block_engine) uploads every width bucket
    whole, so G is bounded by device memory on every path (the reference's
    own doc plans memory batching for exactly this case,
    doc/pfaai_algorithm.tex:218-224).  Here each
    (band x col_chunk) block's two genome slabs are gathered host-side and
    shipped bit-packed on demand, with the _slab_store LRU keeping the
    hottest slabs device-resident — device memory is O(budget), G is
    bounded by host RAM.  Upload/compute overlap comes free from async
    dispatch: the next chunk's slab crosses the wire while the current
    block computes (double buffering without explicit machinery).

    Same contract as _bucket_block_engine:
    ``block_sn(rids, cids, drids, dcids, nb, nc) -> (s, n)`` device arrays.
    """
    import jax

    cache = getattr(presence, "_staged_engine_cache", None)
    if cache is None:
        cache = {}
        presence._staged_engine_cache = cache
    key = jax.default_backend()
    if key in cache:
        return cache[key]

    from .etl.database import bucket_bounds

    order, bounds = bucket_bounds(presence.widths)
    plan = [(order[k:i], kb) for k, i, kb in bounds]
    fetch = _slab_store(presence)

    def block_sn(rids, cids, drids, dcids, nb, nc):
        rids = np.asarray(rids)
        cids = np.asarray(cids)
        drids = np.asarray(drids)
        dcids = np.asarray(dcids)
        s = n = None
        for bi, pci, idx, kb in _split_plan(plan, max(len(rids), len(cids))):
            ma = fetch((bi, pci), idx, kb, rids)
            mb = fetch((bi, pci), idx, kb, cids)
            ta = jnp.asarray(presence.t[np.ix_(idx, drids)])
            tb = jnp.asarray(presence.t[np.ix_(idx, dcids)])
            s_b, n_b = fused_sn_block(ma, mb, ta, tb)
            s = s_b if s is None else s + s_b
            n = n_b if n is None else n + n_b
        return s, n

    cache[key] = block_sn
    return block_sn


def _choose_block_engine(presence: PresenceData, staged: bool | None = None):
    """Resident engine when the presence buckets fit the device budget,
    staged slab engine beyond it (see _use_staged for the resolution
    order).  Both return the same block_sn contract."""
    if _use_staged(presence, staged):
        return _staged_block_engine(presence)
    return _bucket_block_engine(presence)


def _staged_count_engine(presence: PresenceData):
    """Staged twin of _bucket_count_engine for the banded exact path:
    integer count blocks from on-demand slabs (same _slab_store, same
    out-dtype rule), so --streamed --exact also runs at any G the host can
    hold."""
    import jax

    cache = getattr(presence, "_staged_count_cache", None)
    if cache is None:
        cache = {}
        presence._staged_count_cache = cache
    backend = jax.default_backend()
    if backend in cache:
        return cache[backend]

    from .etl.database import bucket_bounds

    order, bounds = bucket_bounds(presence.widths)
    plan = [(order[k:i], kb) for k, i, kb in bounds]
    fetch = _slab_store(presence)
    out_dtype = _count_wire_dtype(presence)

    @jax.jit
    def slab_counts(ma, mb):
        def step(_, inp):
            mpa, mpb = inp
            cnt = jax.lax.dot_general(
                mpa, mpb, (((1,), (1,)), ((), ())),
                preferred_element_type=jnp.int32,
            )
            return None, cnt.astype(out_dtype)

        _, out = jax.lax.scan(step, None, (ma, mb))
        return out

    def block_counts(rids, cids, nb, nc):
        rids = np.asarray(rids)
        cids = np.asarray(cids)
        return [
            (
                idx,
                slab_counts(
                    fetch((bi, pci), idx, kb, rids),
                    fetch((bi, pci), idx, kb, cids),
                ),
            )
            for bi, pci, idx, kb in _split_plan(
                plan, max(len(rids), len(cids))
            )
        ]

    cache[backend] = block_counts
    return block_counts


def _bucket_count_engine(presence: PresenceData):
    """Banded integer-count block engine for the streamed exact path.

    Returns ``block_counts(rids, cids, nb, nc) -> [(protein_idx, counts)]``
    where each counts is a device (Pb, nb, nc) integer array (int16 when
    max(T) < 2^15, halving the transfer — same rule as compute()).  Counts
    are exact integers on any backend; the width buckets permute proteins,
    so callers reassemble into original protein order via protein_idx (the
    f64 finish order is what parity rides on)."""
    import jax

    cache = getattr(presence, "_count_engine_cache", None)
    if cache is None:
        cache = {}
        presence._count_engine_cache = cache
    key = jax.default_backend()
    if key in cache:
        return cache[key]

    buckets = _device_buckets(presence)
    out_dtype = _count_wire_dtype(presence)

    @partial(jax.jit, static_argnames=("nb", "nc"))
    def bucket_counts(md, rids, cids, nb, nc):
        ma = jnp.take(md, rids, axis=1)
        mb = jnp.take(md, cids, axis=1)

        def step(_, inp):
            mpa, mpb = inp
            cnt = jax.lax.dot_general(
                mpa, mpb, (((1,), (1,)), ((), ())),
                preferred_element_type=jnp.int32,
            )
            return None, cnt.astype(out_dtype)

        _, out = jax.lax.scan(step, None, (ma, mb))
        return out

    def block_counts(rids, cids, nb, nc):
        return [
            (idx, bucket_counts(md, rids, cids, nb, nc))
            for idx, md, _ in buckets
        ]

    cache[key] = block_counts
    return block_counts


def _count_wire_dtype(presence: PresenceData):
    """Narrowest dtype that can carry every intersection count on the wire
    (counts are bounded by max(T); int16 halves the download bytes)."""
    return jnp.int16 if int(presence.t.max()) < 2**15 else jnp.int32


def _count_scan_step(out_dtype):
    """Per-protein integer Gram step shared by the mesh count engines: int8
    operands contract with an int32 accumulator (tensor cores), then narrow
    to the wire dtype.  Exact on any backend/sharding."""

    def step(_, inp):
        mpa, mpb = inp
        cnt = jax.lax.dot_general(
            mpa, mpb, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32,
        )
        return None, cnt.astype(out_dtype)

    return step


def _mesh_count_engine(presence: PresenceData, mesh):
    """Resident mesh twin of _bucket_count_engine: integer count blocks for
    the banded exact path, produced over a (rows, scp) device mesh.

    Counts are exact integers on any backend, so sharding changes nothing
    about the values (the reference is bit-exact at every scale it runs,
    algorithm_impl.hpp:222-277, and its doc plans memory batching for big
    problems, doc/pfaai_algorithm.tex:218-224 — this is that exactness
    carried across devices).  Each ``scp`` shard holds
    a protein slice of the presence buckets and computes its slice's Gram
    counts; each ``rows`` shard computes its slice of the band — the output
    block is laid out Spec('scp', 'rows', None) with NO collectives inside
    the program (the f64 finish needs per-protein counts, so there is
    nothing to psum; the only cross-device step is the host gather).  The
    primary's native f64 finish + CSV write are unchanged, so the CSV is
    byte-identical by construction while count production — the only phase
    that scales — runs N devices wide.

    Same ``block_counts(rids, cids, nb, nc) -> [(protein_idx, counts)]``
    contract as _bucket_count_engine, except counts carry scp-padding rows
    (zero proteins are inert: cnt == 0): consumers slice ``[:len(idx)]``.
    len(rids) must divide by the rows axis (compute_streamed_exact's mesh
    branch rounds the band up).
    """
    import jax

    cache = getattr(presence, "_mesh_count_cache", None)
    if cache is None:
        cache = {}
        presence._mesh_count_cache = cache
    key = _mesh_key(mesh)
    if key in cache:
        return cache[key]

    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as Spec

    from .etl.database import bucketize_presence

    n_scp = mesh.shape.get("scp", 1)
    shard3 = NamedSharding(mesh, Spec("scp", None, None))
    out_dtype = _count_wire_dtype(presence)
    buckets = []
    for idx, m_b, _ in bucketize_presence(presence):
        pb = m_b.shape[0]
        pp = -(-pb // n_scp) * n_scp
        if pp != pb:  # zero proteins are inert (cnt == 0 everywhere)
            m_b = np.pad(m_b, ((0, pp - pb), (0, 0), (0, 0)))
        buckets.append((idx, upload_presence_sharded(m_b, shard3)))

    @jax.jit
    def bucket_counts(md, rids, cids):
        def body(md_l, rids_l, cids_l):
            ma = jnp.take(md_l, rids_l, axis=1)
            mb = jnp.take(md_l, cids_l, axis=1)

            _, out = jax.lax.scan(
                _count_scan_step(out_dtype), None, (ma, mb)
            )
            return out

        return shard_map(
            body,
            mesh=mesh,
            in_specs=(Spec("scp", None, None), Spec("rows"), Spec()),
            out_specs=Spec("scp", "rows", None),
        )(md, rids, cids)

    def block_counts(rids, cids, nb, nc):
        r = jnp.asarray(np.asarray(rids))
        c = jnp.asarray(np.asarray(cids))
        return [(idx, bucket_counts(md, r, c)) for idx, md in buckets]

    cache[key] = block_counts
    return block_counts


def _staged_mesh_count_engine(presence: PresenceData, mesh):
    """Staged mesh twin of _staged_count_engine: exact count blocks from
    on-demand slabs SHARDED over the (rows, scp) mesh (_mesh_slab_store),
    so ``--streamed --exact --mesh --staged`` runs at any G the hosts can
    hold — exactness, capacity and device count composed.  Contract and
    padding semantics as
    _mesh_count_engine (consumers slice ``[:len(idx)]``)."""
    import jax

    cache = getattr(presence, "_staged_mesh_count_cache", None)
    if cache is None:
        cache = {}
        presence._staged_mesh_count_cache = cache
    key = _mesh_key(mesh)
    if key in cache:
        return cache[key]

    from jax import shard_map
    from jax.sharding import PartitionSpec as Spec

    from .etl.database import bucket_bounds

    order, bounds = bucket_bounds(presence.widths)
    plan = [(order[k:i], kb) for k, i, kb in bounds]
    fetch = _mesh_slab_store(presence, mesh)
    out_dtype = _count_wire_dtype(presence)

    @jax.jit
    def slab_counts(ma, mb):
        def body(ma_l, mb_l):
            _, out = jax.lax.scan(
                _count_scan_step(out_dtype), None, (ma_l, mb_l)
            )
            return out

        return shard_map(
            body,
            mesh=mesh,
            in_specs=(
                Spec("scp", "rows", None),
                Spec("scp", None, None),
            ),
            out_specs=Spec("scp", "rows", None),
        )(ma, mb)

    def block_counts(rids, cids, nb, nc):
        rids = np.asarray(rids)
        cids = np.asarray(cids)
        return [
            (
                idx,
                slab_counts(
                    fetch((bi, pci), idx, kb, rids, "row"),
                    fetch((bi, pci), idx, kb, cids, "col"),
                ),
            )
            for bi, pci, idx, kb in _split_plan(
                plan, max(len(rids), len(cids))
            )
        ]

    cache[key] = block_counts
    return block_counts


def _bucket_block_engine(presence: PresenceData):
    """Single-device banded (S, N) block engine shared by compute_streamed
    and compute_fast.

    Returns ``block_sn(rids, cids, drids, dcids, nb, nc) -> (s, n)`` device
    arrays for one (nb x nc) output block, summed over the width buckets:
    one jitted program gathers the band's genome rows on device and runs
    the fused block (ops.fused.fused_sn_block).

    The engine (uploaded buckets + jit wrapper) is cached on the presence
    object, so repeated library-API calls (api.aji) and mixed
    compute_fast/compute_streamed use of one PresenceData neither re-upload
    the presence tensor nor retrace."""
    import jax

    cache = getattr(presence, "_block_engine_cache", None)
    if cache is None:
        cache = {}
        presence._block_engine_cache = cache
    key = jax.default_backend()
    if key in cache:
        return cache[key]

    buckets = [(md, td) for _, md, td in _device_buckets(presence)]

    @partial(jax.jit, static_argnames=("nb", "nc"))
    def bucket_sn(md, td, rids, cids, drids, dcids, nb, nc):
        ma = jnp.take(md, rids, axis=1)
        mb = jnp.take(md, cids, axis=1)
        ta = jnp.take(td, drids, axis=1)
        tb = jnp.take(td, dcids, axis=1)
        return fused_sn_block(ma, mb, ta, tb)

    def block_sn(rids, cids, drids, dcids, nb, nc):
        s = n = None
        for md_b, td_b in buckets:
            s_b, n_b = bucket_sn(md_b, td_b, rids, cids, drids, dcids, nb, nc)
            s = s_b if s is None else s + s_b
            n = n_b if n is None else n + n_b
        return s, n

    cache[key] = block_sn
    return block_sn


def _staged_col_group(
    presence: PresenceData,
    band: int,
    col_chunk: int,
    n_chunks: int,
    staged: bool | None,
) -> int:
    """Column chunks per traversal group for staged block walks: sized so a
    full group's column slabs plus one row band's slab set fit the slab LRU
    (0.75 of the budget — _slab_store's own cap) with headroom for the
    in-flight generation.  Resident engines get n_chunks back (a single
    group == the plain row-major walk; order is irrelevant when every bucket
    stays uploaded)."""
    if n_chunks <= 1 or not _use_staged(presence, staged):
        return max(1, n_chunks)
    g = max(1, presence.m.shape[1])
    per_genome = presence_device_bytes(presence) / g
    cap = _slab_cap()
    if cap == float("inf"):
        return n_chunks
    avail = cap - band * per_genome
    if avail <= 0 or per_genome <= 0:
        return 1
    return max(
        1, min(n_chunks, int(avail * 0.8 / (per_genome * col_chunk)))
    )


def _banded_sn(
    presence: PresenceData,
    row_ids: np.ndarray,
    col_ids: np.ndarray,
    row_denom_ids: np.ndarray,
    col_denom_ids: np.ndarray,
    band: int = 1024,
    col_chunk: int = 4096,
    staged: bool | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Full (len(row_ids), len(col_ids)) S/N matrices on host, computed in
    streamed-shaped device blocks (same program as compute_streamed; see
    _bucket_block_engine) with async host copies overlapping dispatch.

    Device result blocks are drained into the host arrays a fixed depth
    behind dispatch (depth 2 keeps the async-copy overlap), so device
    residency stays O(depth * band * col_chunk) instead of growing with the
    whole result matrix (at G=16384 an unbounded pending list would hold
    ~2 GB of device memory on top of the presence buckets).  When the
    presence buckets themselves exceed the device budget, blocks run on the staged slab
    engine instead (_choose_block_engine) — and the block walk switches from
    row-band-major to COLUMN-GROUP-major: all row bands of an LRU-sized
    group of column chunks run before moving on, so each column slab ships
    once per group instead of once per band (the row-major walk re-ships
    the full column slab set every band).  The result assembly is
    order-independent, so the values are identical."""
    row_ids = np.asarray(row_ids, np.int32)
    col_ids = np.asarray(col_ids, np.int32)
    s = np.zeros((len(row_ids), len(col_ids)), dtype=np.float32)
    n = np.zeros((len(row_ids), len(col_ids)), dtype=np.int32)
    if len(row_ids) == 0 or len(col_ids) == 0:
        return s, n
    block_sn = _choose_block_engine(presence, staged)
    row_denom_ids = np.asarray(row_denom_ids, np.int32)
    col_denom_ids = np.asarray(col_denom_ids, np.int32)
    band = min(band, len(row_ids))
    col_chunk = min(col_chunk, len(col_ids))
    pending: list[tuple] = []

    def drain_one() -> None:
        r0, nr, c0, nc, s_b, n_b = pending.pop(0)
        s[r0 : r0 + nr, c0 : c0 + nc] = np.asarray(s_b)[:nr, :nc]
        n[r0 : r0 + nr, c0 : c0 + nc] = np.asarray(n_b)[:nr, :nc]

    # Symmetric problems (all-vs-all fast path: rows == cols, same
    # denominators): blocks ENTIRELY below the diagonal are the elementwise
    # transpose of above-diagonal work (counts and the commutative
    # denominator sums are symmetric => identical f32 per cell), so they are
    # skipped and filled from the transpose after assembly — no new device
    # program shape (straddling blocks compute fully), device MACs and S/N
    # downloads approach half as G / col_chunk grows.
    symmetric = (
        len(row_ids) == len(col_ids)
        and np.array_equal(row_ids, col_ids)
        and np.array_equal(row_denom_ids, col_denom_ids)
    )
    col_starts = list(range(0, len(col_ids), col_chunk))
    group_n = _staged_col_group(
        presence, band, col_chunk, len(col_starts), staged
    )
    for g0 in range(0, len(col_starts), group_n):
        group = col_starts[g0 : g0 + group_n]
        for r0 in range(0, len(row_ids), band):
            if symmetric and group[-1] + col_chunk <= r0:
                continue  # the whole group is below the diagonal here
            rids = row_ids[r0 : r0 + band]
            pad_r = band - len(rids)
            rpad = np.pad(rids, (0, pad_r))
            drpad = np.pad(row_denom_ids[r0 : r0 + band], (0, pad_r))
            for c0 in group:
                if symmetric and c0 + col_chunk <= r0:
                    continue
                cids = col_ids[c0 : c0 + col_chunk]
                pad_c = col_chunk - len(cids)
                cpad = np.pad(cids, (0, pad_c))
                dcpad = np.pad(
                    col_denom_ids[c0 : c0 + col_chunk], (0, pad_c)
                )
                s_b, n_b = block_sn(rpad, cpad, drpad, dcpad, band, col_chunk)
                for arr in (s_b, n_b):
                    if hasattr(arr, "copy_to_host_async"):
                        arr.copy_to_host_async()
                pending.append((r0, len(rids), c0, len(cids), s_b, n_b))
                while len(pending) > 2:
                    drain_one()
    while pending:
        drain_one()
    if symmetric:
        # Blockwise transpose fill (np.tril_indices at G=16384 would
        # allocate two ~1 GB int64 index vectors plus gather copies).
        for r0 in range(0, len(row_ids), band):
            r1 = min(r0 + band, len(row_ids))
            s[r0:r1, :r0] = s[:r0, r0:r1].T
            n[r0:r1, :r0] = n[:r0, r0:r1].T
    return s, n


def compute_streamed(
    presence: PresenceData,
    row_ids: np.ndarray,
    col_ids: np.ndarray,
    out_path: str,
    row_names: tuple[str, ...],
    col_names: tuple[str, ...],
    separator: str = ",",
    band: int = 1024,
    col_chunk: int = 4096,
    resume: bool = False,
    mesh=None,
    row_denom_ids: np.ndarray | None = None,
    col_denom_ids: np.ndarray | None = None,
    staged: bool | None = None,
) -> None:
    """Memory-bounded production path: AJI straight to CSV in row bands.

    For genome counts where the (G, G) result or the (P, n_pairs) count
    matrix no longer fits (G ~ 10^5 => 5 * 10^9 pairs), neither the exact
    engine nor the fused full-matrix kernels apply.  This path walks the
    output in (band x col_chunk) blocks — each block is one fused-device call
    (ops.fused.fused_sn_block) and one masked-AJI f32 transfer — so host and
    device memory stay O(P*G*K + band*G) regardless of G, and the CSV is
    written incrementally in row order (reference layout, src/main.cpp:133-175:
    header of column names, one row per row genome, same-genome cells 0).
    Bands are software-pipelined: band k+1's device blocks are dispatched
    (with async host copies) before band k is materialized, and a writer
    thread formats/writes band k-1 concurrently — device compute, host
    transfer, and CSV IO all overlap.  Symmetric (all-vs-all) runs skip the
    column chunks entirely below the diagonal and fill those regions from
    the assembled bands already produced (bit-identical values; see the
    sym_stream block below) — device MACs and result downloads approach
    half, at the cost of holding the assembled bands (up to G^2 * 4 bytes)
    on host; gated by PARFASTAAI_MIRROR_BYTES (default 4 GiB; set to 1 for
    strict O(band x G) memory) and disabled on resume.

    f32 on device (~1e-7 relative error, like compute_fast); denominator T
    columns default to the DB id columns but callers can override them via
    ``row_denom_ids`` / ``col_denom_ids`` (PairSpace carries them), so the
    two-database compat T-swap (modes.query_target) is honored here too.

    Args:
      row_ids / col_ids: presence-tensor genome indices of the CSV rows /
        columns, in output order.
      row_denom_ids / col_denom_ids: T columns used in the denominators for
        each row / column (default: same as row_ids / col_ids).
      band / col_chunk: block shape; G is processed in ceil-divided blocks
        with zero-genome padding (padded entries never reach the CSV).
      resume: continue an interrupted run — complete rows already present in
        ``out_path`` are kept (a trailing partial line is truncated) and
        computation restarts at the first missing row.  The CSV itself is the
        checkpoint; there is no sidecar state.
      mesh: optional jax Mesh with a ``rows`` axis — each band's rows are
        sharded across the axis (presence tensor replicated), the
        multi-device combination of banding and data parallelism.
      staged: presence-slab staging for tensors larger than device memory —
        True forces it, False forces resident buckets, None (default)
        auto-selects against the device budget (_use_staged /
        _use_staged_mesh).  Composes with ``mesh``: staged-mesh runs ship
        each block's slabs already sharded over (rows, scp), so genome
        capacity scales with host RAM x device count
        (_staged_mesh_block_engine).
    """
    import jax

    from .io.csv_writer import format_matrix

    row_ids = np.asarray(row_ids, dtype=np.int32)
    col_ids = np.asarray(col_ids, dtype=np.int32)
    row_denom_ids = (
        row_ids
        if row_denom_ids is None
        else np.asarray(row_denom_ids, dtype=np.int32)
    )
    col_denom_ids = (
        col_ids
        if col_denom_ids is None
        else np.asarray(col_denom_ids, dtype=np.int32)
    )
    # Clamp to >= 1 so empty axes degrade to a header-only CSV instead of a
    # zero-step range() error.
    band = max(1, min(band, len(row_ids)))
    col_chunk = max(1, min(col_chunk, len(col_ids)))

    # Meta-only presence (broadcast_presence meta_only=True) carries no
    # tensor bytes off-primary — the host-BLAS fallback is impossible by
    # construction, so the mesh path must win regardless of problem size.
    _meta_only = mesh is not None and getattr(
        presence, "slab_broadcast", False
    )
    _take_host = not _meta_only and _use_host(presence)
    if jax.process_count() > 1:
        # _use_host reads per-process env (PARFASTAAI_HOST_WORK_LIMIT /
        # FORCE_DEVICE), so it could diverge across the processes of one
        # run — process A taking the collective-free host path while
        # process B enters the mesh collectives is a deadlock.
        # Process 0's decision wins everywhere (one tiny broadcast; every
        # process reaches this line before any other collective).
        from .parallel.distributed import broadcast_pyobj

        _take_host = bool(broadcast_pyobj(_take_host))
    if _take_host:
        # Problem is host-trivial; skip device dispatch entirely (same
        # rationale as compute's HOST_WORK_LIMIT).  f32 math in the same
        # ascending-protein order as the device scan.
        def block(md, td, rids, cids, drids, dcids, nb, nc):
            rids, cids = np.asarray(rids), np.asarray(cids)
            mf = presence.m.astype(np.float64)
            cnt = np.rint(
                mf[:, rids] @ mf[:, cids].transpose(0, 2, 1)
            ).astype(np.int32)
            ta = presence.t[:, np.asarray(drids)].astype(np.int32)
            tb = presence.t[:, np.asarray(dcids)].astype(np.int32)
            s = np.zeros((len(rids), len(cids)), dtype=np.float32)
            n = np.zeros((len(rids), len(cids)), dtype=np.int32)
            for p in range(cnt.shape[0]):
                shared = cnt[p] > 0
                denom = (ta[p][:, None] + tb[p][None, :] - cnt[p]).astype(
                    np.float32
                )
                with np.errstate(divide="ignore", invalid="ignore"):
                    j = np.where(
                        shared, cnt[p].astype(np.float32) / denom, 0.0
                    )
                s += j
                n += shared
            with np.errstate(divide="ignore", invalid="ignore"):
                return np.where(n == 0, np.float32(0), s / n.astype(np.float32))

        md = td = None
        staged_active = False
    elif mesh is None:
        # Width buckets cut padded tensor-core work ~2.3x on real databases
        # (bucketize_presence).
        block_sn = _choose_block_engine(presence, staged=staged)
        staged_active = _use_staged(presence, staged)

        def block(_md, _td, rids, cids, drids, dcids, nb, nc):
            return _mask_aji(*block_sn(rids, cids, drids, dcids, nb, nc))

        md = td = None
    else:
        from jax import shard_map
        from jax.sharding import NamedSharding, PartitionSpec as Spec

        from .etl.database import bucketize_presence

        # Every device shard runs the same fused block as the
        # single-device streamed path.
        n_rows = mesh.shape["rows"]
        n_scp = mesh.shape.get("scp", 1)
        band = -(-band // n_rows) * n_rows  # shardable bands
        staged_active = _use_staged_mesh(presence, n_scp, staged)
        if jax.process_count() > 1:
            # Same cross-process agreement as _take_host above: the HBM
            # budget check can read different memory stats / env per host,
            # and the staged-mesh engine's slab streaming is collective.
            from .parallel.distributed import broadcast_pyobj

            staged_active = bool(broadcast_pyobj(staged_active))
        if staged_active:
            # Presence exceeds even the scp-sharded per-device residency:
            # feed the mesh from on-demand sharded slabs instead (capacity
            # scales with host RAM x device count).
            block_sn_mesh = _staged_mesh_block_engine(presence, mesh)

            def block(_md, _td, rids, cids, drids, dcids, nb, nc):
                return _mask_aji(
                    *block_sn_mesh(rids, cids, drids, dcids, nb, nc)
                )

        else:
            shard3 = NamedSharding(mesh, Spec("scp", None, None))
            shard2 = NamedSharding(mesh, Spec("scp", None))
            # Same width buckets (and bucket order) as the single-device
            # branch.  With scp == 1 the per-band f32 accumulation order —
            # and the bytes — are identical to the single-device path;
            # scp > 1 splits each bucket's protein scan across devices (psum
            # merge), which reassociates the f32 sum (~1e-7, the fused
            # paths' normal contract).
            buckets = []
            for _, m_b, t_b in bucketize_presence(presence):
                pb = m_b.shape[0]
                pp = -(-pb // n_scp) * n_scp
                if pp != pb:  # zero proteins are inert (cnt == 0 -> j == 0)
                    m_b = np.pad(m_b, ((0, pp - pb), (0, 0), (0, 0)))
                    t_b = np.pad(t_b, ((0, pp - pb), (0, 0)))
                buckets.append(
                    (
                        jax.device_put(m_b, shard3),
                        jax.device_put(t_b, shard2),
                    )
                )

            @partial(jax.jit, static_argnames=("nb", "nc"))
            def bucket_sn(md, td, rids, cids, drids, dcids, nb, nc):
                def body(md, td, rids_loc, cids, drids_loc, dcids):
                    ma = jnp.take(md, rids_loc, axis=1)
                    mb = jnp.take(md, cids, axis=1)
                    ta = jnp.take(td, drids_loc, axis=1)
                    tb = jnp.take(td, dcids, axis=1)
                    s, n = fused_sn_block(
                        ma, mb, ta, tb, vma_axes=("rows", "scp")
                    )
                    return jax.lax.psum(s, "scp"), jax.lax.psum(n, "scp")

                return shard_map(
                    body,
                    mesh=mesh,
                    in_specs=(
                        Spec("scp", None, None),
                        Spec("scp", None),
                        Spec("rows"),
                        Spec(),
                        Spec("rows"),
                        Spec(),
                    ),
                    out_specs=(Spec("rows"), Spec("rows")),
                )(md, td, rids, cids, drids, dcids)

            def block(_md, _td, rids, cids, drids, dcids, nb, nc):
                s = n = None
                for md_b, td_b in buckets:
                    s_b, n_b = bucket_sn(
                        md_b, td_b, rids, cids, drids, dcids, nb, nc
                    )
                    s = s_b if s is None else s + s_b
                    n = n_b if n is None else n + n_b
                return _mask_aji(s, n)

        md = td = None

    from .parallel.distributed import (
        broadcast_from_primary,
        gather_to_host,
        is_primary,
    )

    # Multi-process (jax.distributed) runs: every process executes the block
    # loop (the mesh collectives require it) but only process 0 touches the
    # CSV.  The resume point is read from disk by the writer and broadcast so
    # all processes restart at the same band.
    primary = is_primary()
    multiproc = jax.process_count() > 1
    header = separator + separator.join(col_names) + "\n"
    rows_done = 0
    if resume:
        rows_done = _resume_point(out_path, header, band) if primary else 0
        if multiproc:
            rows_done = broadcast_from_primary(rows_done)
    fp = open(out_path, "a" if rows_done else "w") if primary else None

    # Three-stage software pipeline (device compute, the device->host
    # transfer and the CSV format/write overlap):
    #   stage 1 (main thread): dispatch band k+1's device blocks (async) and
    #     start their host copies (copy_to_host_async);
    #   stage 2 (main thread): materialize band k (the copy is already in
    #     flight) and assemble its row slab;
    #   stage 3 (writer thread): format + write band k-1 — the native
    #     formatter and file writes run without the GIL, so they overlap
    #     stage 1/2 wall-clock.
    import queue as _queue
    import threading

    # Symmetric mirror for the f32 streamed path (r4): all-vs-all runs skip
    # every column chunk ENTIRELY below the diagonal and fill those regions
    # from the assembled bands already produced (aji is symmetric; per-cell
    # f32 arithmetic is commutative in its only asymmetric input, the
    # denominator sum, so filled values are bit-identical) — device MACs
    # and result downloads approach half, with no new device program shape.
    # Requires a fresh run (mirrors need every earlier band from THIS run)
    # and the full assembled-band store (G^2 * 4 bytes) under the budget.
    import os as _os

    _sym_layout = (
        len(row_ids) == len(col_ids)
        and np.array_equal(row_ids, col_ids)
        and np.array_equal(row_denom_ids, col_denom_ids)
    )
    _mirror_budget = int(
        float(_os.environ.get("PARFASTAAI_MIRROR_BYTES", 4 << 30))
    )
    _mirror_fits = len(row_ids) * len(col_ids) * 4 <= _mirror_budget
    sym_stream = _sym_layout and rows_done == 0 and _mirror_fits
    if multiproc:
        # sym_stream decides WHICH column chunks _dispatch gathers — a
        # per-host PARFASTAAI_MIRROR_BYTES divergence would have one
        # process skip collectives another joins (same class as
        # _take_host above).  Process 0 decides.
        from .parallel.distributed import broadcast_pyobj as _bpy

        sym_stream = bool(_bpy(sym_stream))
    if _sym_layout and not sym_stream and primary:
        # Say WHY the half-work mirror is off instead of silently running
        # the full square ("why is my resumed run 2x slower").
        import sys as _sys

        why = (
            "--resume keeps earlier bands this run never produced"
            if rows_done
            else f"assembled-band store {len(row_ids) * len(col_ids) * 4} B"
            f" exceeds PARFASTAAI_MIRROR_BYTES={_mirror_budget}"
        )
        print(
            f"NOTE: symmetric mirror disabled ({why}); computing the "
            "full square",
            file=_sys.stderr,
        )
    band_store: dict[int, np.ndarray] = {}

    write_q: _queue.Queue = _queue.Queue(maxsize=2)
    werr: list[BaseException] = []

    def _writer() -> None:
        try:
            if os.environ.get("PARFASTAAI_TEST_WORKER_FAULT"):
                # Fault-injection hook (tests only): see the exact path's
                # _worker — proves a primary writer failure stops every
                # process via the _abort() broadcast instead of hanging.
                raise RuntimeError("injected csv-writer fault")
            while True:
                item = write_q.get()
                if item is None:
                    return
                r0, rows_aji = item
                for i, row in enumerate(
                    format_matrix(rows_aji.astype(np.float64), separator)
                ):
                    fp.write(row_names[r0 + i] + separator + row + "\n")
        except BaseException as exc:  # surfaced to the producer after join
            werr.append(exc)
            while write_q.get() is not None:  # keep the producer unblocked
                pass

    def _dispatch(r0: int, reverse: bool = False):
        """Issue every device block of one row band; returns device arrays
        with host copies already in flight (nothing here blocks on compute).
        ``reverse`` walks the column chunks right-to-left — staged runs
        alternate direction per band (snake order) so the tail column slabs
        still resident in the LRU are reused instead of re-shipped (the
        CSV's row order pins the band order, so the column walk is the only
        reuse lever here).  Assembly keys on c0, so bytes
        are identical."""
        rids = row_ids[r0 : r0 + band]
        pad_r = band - len(rids)
        rpad = np.pad(rids, (0, pad_r))
        drpad = np.pad(row_denom_ids[r0 : r0 + band], (0, pad_r))
        chunks = []
        c0s = list(range(0, len(col_ids), col_chunk))
        if reverse:
            c0s.reverse()
        for c0 in c0s:
            if sym_stream and c0 + col_chunk <= r0:
                continue  # below the diagonal: filled from earlier bands
            cids = col_ids[c0 : c0 + col_chunk]
            pad_c = col_chunk - len(cids)
            cpad = np.pad(cids, (0, pad_c))
            dcpad = np.pad(col_denom_ids[c0 : c0 + col_chunk], (0, pad_c))
            aji = block(md, td, rpad, cpad, drpad, dcpad, band, col_chunk)
            if multiproc:
                aji = gather_to_host(aji)  # collective: every process joins
            elif hasattr(aji, "copy_to_host_async"):
                aji.copy_to_host_async()
            chunks.append((c0, len(cids), aji))
        return rids, chunks

    def _assemble(r0: int, rids: np.ndarray, chunks) -> np.ndarray:
        rows_aji = np.zeros((len(rids), len(col_ids)), dtype=np.float32)
        for c0, ncols, aji in chunks:
            rows_aji[:, c0 : c0 + ncols] = np.asarray(aji)[
                : len(rids), :ncols
            ]
        if sym_stream:
            # Skipped region [0, fill_end): transpose slices of the stored
            # earlier bands (all complete — only the final band can be
            # short, and nothing mirrors from it).
            fill_end = (r0 // col_chunk) * col_chunk
            for bs in range(0, fill_end, band):
                width = min(band, fill_end - bs)
                rows_aji[:, bs : bs + width] = band_store[bs][
                    :width, r0 : r0 + len(rids)
                ].T
        # Reference leaves same-genome cells untouched => 0.  (n == 0 cells
        # were already zeroed on device by _mask_aji.)
        rows_aji[rids[:, None] == col_ids[None, :]] = 0.0
        if sym_stream:
            band_store[r0] = rows_aji
        return rows_aji

    writer = (
        threading.Thread(target=_writer, name="pfaai-csv-writer", daemon=True)
        if primary
        else None
    )
    try:
        if primary:
            try:
                if not rows_done:
                    fp.write(header)
            except BaseException as exc:
                # Primary-only raise before the first _abort() broadcast
                # would strand the other processes (see the exact path).
                werr.append(exc)
            writer.start()

        def _abort() -> bool:
            # werr (the writer thread's failure) exists only on the
            # primary; a multi-process run must agree to stop or the other
            # processes hang in _dispatch's per-chunk gather collective the
            # primary never joins.  One int64 broadcast per band.
            flag = 1 if werr else 0
            if multiproc:
                flag = broadcast_from_primary(flag)
            return bool(flag)

        pending = None  # (r0, rids, chunks) of the band one step behind
        for bi, r0 in enumerate(range(rows_done, len(row_ids), band)):
            rids, chunks = _dispatch(r0, staged_active and bi % 2 == 1)
            if pending is not None and primary:
                try:
                    pr0, prids, pchunks = pending
                    write_q.put((pr0, _assemble(pr0, prids, pchunks)))
                except BaseException as exc:
                    # Primary-only raise (e.g. MemoryError growing the
                    # mirror band_store) must flow through the _abort()
                    # broadcast below, not unwind past it and strand the
                    # other processes in their next collective.
                    werr.append(exc)
            pending = (r0, rids, chunks)
            if _abort():
                break
        if pending is not None and primary and not werr:
            pr0, prids, pchunks = pending
            write_q.put((pr0, _assemble(pr0, prids, pchunks)))
    finally:
        if writer is not None and writer.is_alive():
            write_q.put(None)
            writer.join()
        if fp is not None:
            fp.close()
    if werr:
        raise werr[0]


def compute_streamed_exact(
    presence: PresenceData,
    row_ids: np.ndarray,
    col_ids: np.ndarray,
    out_path: str,
    row_names: tuple[str, ...],
    col_names: tuple[str, ...],
    separator: str = ",",
    band: int = 512,
    col_chunk: int = 2048,
    resume: bool = False,
    row_denom_ids: np.ndarray | None = None,
    col_denom_ids: np.ndarray | None = None,
    staged: bool | None = None,
    mesh=None,
) -> None:
    """Banded EXACT engine: bit-parity f64 AJI straight to CSV.

    The default exact path (compute) downloads the whole (P, n_pairs) count
    matrix — ~21 GB at G=16384 — so beyond screening scale, parity used to
    be abandoned for f32.  This path keeps the
    reference's exactness semantics (algorithm_impl.hpp:222-277: integer
    intersections, f64 S accumulated in ascending protein order) at ANY G:
    per (band x col_chunk) output block it pulls the integer counts (device
    int8 Gram via _bucket_count_engine, int16 on the wire when max(T) <
    2^15; host f64 BLAS under HOST_WORK_LIMIT), runs the native banded f64
    finish (jaccard_finish_block — identical operation order to compute's
    finish), and appends the CSV rows.  Memory is O(P * band * col_chunk)
    host + device, independent of G.

    The CSV is byte-identical to compute() + write_aji_csv for every mode:
    same f64 values (exact integer counts + same finish order), same
    formatter, pairs with no shared protein print ``nan`` (reference 0/0,
    algorithm_impl.hpp:318), and same-genome cells print ``0`` (untouched in
    the reference's scatter, src/main.cpp:133-175).

    ``resume`` reuses the streamed checkpoint contract: complete band-aligned
    rows already in ``out_path`` are kept, computation restarts at the first
    missing row (the CSV is the checkpoint).

    Two-stage software pipeline: the main thread dispatches each block's
    device count programs and starts their host copies
    (copy_to_host_async), while a worker thread — up to two blocks behind —
    materializes the counts (the copy is already in flight), runs the
    native OpenMP f64 finish and the CSV format/write (both release the
    GIL).  Device compute, transfer, host f64 math, and file IO all
    overlap; result order is preserved because the queue is FIFO and one
    worker consumes it.

    Symmetric (all-vs-all) runs additionally compute ONLY the
    diagonal-and-above blocks: intersection counts are symmetric, so each
    below-diagonal block's finished f64 AJI tile is the transpose of an
    above-diagonal tile the worker already produced (held in a mirror store,
    popped at its single use).  This halves both the device MACs and the
    count-download bytes — the dominant cost at any scale — with bit-identical
    results (same integer counts, same per-cell f64 operation order).
    Engages when rows == cols (ids and denominators), no resume rows exist,
    and the peak mirror footprint (~2 * G^2 bytes) fits
    PARFASTAAI_MIRROR_BYTES (default 4 GiB; G ~ 23k at the default band).

    ``mesh`` (a jax Mesh with ``rows`` and optional ``scp`` axes) shards the
    count-block production over the pod: integer counts are exact on any
    backend and any sharding, so the mesh multiplies the throughput of the
    only phase that scales while the primary-side f64 finish + CSV write —
    and therefore the bytes — stay identical (_mesh_count_engine /
    _staged_mesh_count_engine; the staged variant auto-engages over
    _use_staged_mesh so exactness composes with pod-scale genome capacity
    too).  Multi-process runs with a mesh have every process join the
    dispatch loop (the gather collective requires it); without a mesh they
    keep the single-computing-primary behavior.
    """
    import queue as _queue
    import sys
    import threading

    import jax

    from .io.csv_writer import format_matrix
    from .parallel.distributed import (
        broadcast_from_primary,
        broadcast_pyobj,
        gather_to_host,
        is_primary,
    )

    primary = is_primary()
    multiproc = jax.process_count() > 1
    if multiproc and mesh is None:
        if not primary:
            return  # no collectives here; one process computes and writes
        print(
            "WARNING: the banded exact engine without --mesh computes on "
            "the primary process only; the other "
            f"{jax.process_count() - 1} process(es) idle through this phase "
            "(pass --mesh R,S to shard the exact count production, or use "
            "--fast/--streamed for f32 multi-process compute)",
            file=sys.stderr,
        )
        multiproc = False  # from here on this is a single-process run

    row_ids = np.asarray(row_ids, dtype=np.int32)
    col_ids = np.asarray(col_ids, dtype=np.int32)
    row_denom_ids = (
        row_ids
        if row_denom_ids is None
        else np.asarray(row_denom_ids, dtype=np.int32)
    )
    col_denom_ids = (
        col_ids
        if col_denom_ids is None
        else np.asarray(col_denom_ids, dtype=np.int32)
    )
    band = max(1, min(band, len(row_ids)))
    col_chunk = max(1, min(col_chunk, len(col_ids)))
    if mesh is not None:
        # Shardable bands (padded rows are inert and never reach the CSV);
        # the mesh overrides the host-BLAS dispatch by definition.
        use_host = False
        band = -(-band // mesh.shape["rows"]) * mesh.shape["rows"]
        _staged_mesh = _use_staged_mesh(
            presence, mesh.shape.get("scp", 1), staged
        )
        if multiproc:
            # Agree across processes (same rationale as compute_streamed:
            # the two count engines have different collective patterns).
            _staged_mesh = bool(broadcast_pyobj(_staged_mesh))
        if _staged_mesh:
            block_counts = _staged_mesh_count_engine(presence, mesh)
        else:
            block_counts = _mesh_count_engine(presence, mesh)
    else:
        use_host = _use_host(presence)
        if use_host:
            block_counts = None
        elif _use_staged(presence, staged):
            block_counts = _staged_count_engine(presence)
        else:
            block_counts = _bucket_count_engine(presence)
    t = presence.t
    P = t.shape[0]

    header = separator + separator.join(col_names) + "\n"
    rows_done = (
        _resume_point(out_path, header, band) if resume and primary else 0
    )
    if multiproc:
        rows_done = broadcast_from_primary(rows_done)
    # Symmetric-reuse resolution (see docstring): square blocks so each
    # below-diagonal block is exactly the transpose of a stored tile.
    sym_layout = (
        len(row_ids) == len(col_ids)
        and np.array_equal(row_ids, col_ids)
        and np.array_equal(row_denom_ids, col_denom_ids)
    )
    if sym_layout and rows_done:
        print(
            "NOTE: symmetric mirror disabled on --resume (mirrors need "
            "every earlier band from this run); the remaining bands compute "
            "the full square",
            file=sys.stderr,
        )
    sym = sym_layout and rows_done == 0
    if sym:
        import os as _os

        # Budget check BEFORE adopting the square col_chunk: overwriting
        # first left a disabled-sym run with the shrunken chunk — e.g. 512
        # instead of the caller's 2048, quadrupling block dispatches.
        n_ch = -(-len(col_ids) // band)
        # Peak live mirror tiles = max_i (i+1)(n-1-i) ~ n^2/4 f64 tiles.
        peak = ((n_ch * n_ch) // 4 + 1) * band * band * 8
        budget = int(
            float(_os.environ.get("PARFASTAAI_MIRROR_BYTES", 4 << 30))
        )
        if peak > budget:
            import sys as _sys

            sym = False
            print(
                "NOTE: symmetric mirror disabled — peak mirror bytes "
                f"{peak} exceed PARFASTAAI_MIRROR_BYTES={budget}; "
                "computing the full square",
                file=_sys.stderr,
            )
    if multiproc:
        # sym decides the per-band chunk count and which blocks hit the
        # gather collective — a per-host PARFASTAAI_MIRROR_BYTES divergence
        # would break the one-_abort()-per-iteration invariant and hang
        # the pod.  Process 0 decides.
        sym = bool(broadcast_pyobj(sym))
    if sym:
        col_chunk = band  # square blocks so mirrors transpose exactly
    fp = open(out_path, "a" if rows_done else "w") if primary else None

    # Worker (stage 2): per queued block, materialize counts, f64-finish,
    # and — on a band boundary — format + write the completed band.  Bounded
    # queue depth 2 keeps device-result residency O(depth * P * band *
    # col_chunk) while the async host copies stay a step ahead.
    work_q: _queue.Queue = _queue.Queue(maxsize=2)
    werr: list[BaseException] = []

    n_chunks_per_band = max(1, -(-len(col_ids) // col_chunk))

    def _worker() -> None:
        try:
            if os.environ.get("PARFASTAAI_TEST_WORKER_FAULT"):
                # Fault-injection hook (tests only): prove a primary-side
                # finish failure aborts the whole pod via the _abort()
                # broadcast instead of stranding non-primaries in the
                # gather collective.
                raise RuntimeError("injected finish-worker fault")
            cur_r0 = -1
            cur_rids: np.ndarray | None = None
            rows_aji: np.ndarray | None = None
            chunks_done = 0
            mirror: dict[tuple[int, int], np.ndarray] = {}

            def flush() -> None:
                nonlocal rows_aji
                if rows_aji is None:
                    return
                if chunks_done < n_chunks_per_band:
                    # Producer aborted mid-band (device error, interrupt):
                    # the unfilled chunks are np.empty garbage.  Discard —
                    # writing them would bake a complete-looking band into
                    # the CSV that --resume would then keep as a checkpoint.
                    rows_aji = None
                    return
                # Same-genome cells are untouched in the reference => 0.
                rows_aji[cur_rids[:, None] == col_ids[None, :]] = 0.0
                for i, row in enumerate(format_matrix(rows_aji, separator)):
                    fp.write(row_names[cur_r0 + i] + separator + row + "\n")
                rows_aji = None

            while True:
                item = work_q.get()
                if item is None:
                    flush()
                    return
                r0, rids, drids, c0, nc, dcids, kind, data = item
                if r0 != cur_r0:
                    flush()
                    cur_r0, cur_rids = r0, rids
                    chunks_done = 0
                    rows_aji = np.empty(
                        (len(rids), len(col_ids)), dtype=np.float64
                    )
                chunks_done += 1
                if kind == "mirror":
                    # Transpose of an above-diagonal tile finished earlier
                    # (FIFO guarantees it exists); each tile mirrors once.
                    rows_aji[:, c0 : c0 + nc] = mirror.pop(data).T
                    continue
                payload, store_key = data
                nr = len(rids)
                if isinstance(payload, np.ndarray):
                    counts = payload
                else:
                    dtype = np.asarray(payload[0][1]).dtype
                    counts = np.empty((P, nr, nc), dtype=dtype)
                    for idx, dev in payload:
                        # [:len(idx)]: mesh count engines pad the protein
                        # axis to the scp shard count (padded rows are 0).
                        counts[idx] = np.asarray(dev)[: len(idx), :nr, :nc]
                s, n = jaccard_finish_block(counts, t[:, drids], t[:, dcids])
                with np.errstate(divide="ignore", invalid="ignore"):
                    blk = s / n  # 0/0 -> nan (parity)
                rows_aji[:, c0 : c0 + nc] = blk
                if store_key is not None:
                    mirror[store_key] = blk
        except BaseException as exc:  # surfaced to the producer after join
            werr.append(exc)
            while work_q.get() is not None:  # keep the producer unblocked
                pass

    worker = (
        threading.Thread(
            target=_worker, name="pfaai-exact-finish", daemon=True
        )
        if primary
        else None
    )
    aborted = False

    def _abort() -> bool:
        # werr (the finish worker's failure) exists only on the primary; in
        # a multi-process mesh run every process must agree to stop, or the
        # survivors hang in the next gather collective the primary never
        # joins.  One int64 broadcast per output block — negligible next to
        # the gathered count bytes.  Call sites are placed so every process
        # makes exactly one call per inner iteration.
        flag = 1 if werr else 0
        if multiproc:
            flag = broadcast_from_primary(flag)
        return bool(flag)

    try:
        if primary:
            try:
                if not rows_done:
                    fp.write(header)
            except BaseException as exc:
                # A primary-only raise BEFORE the first _abort() broadcast
                # would strand the other processes; route it through werr
                # so the per-block protocol delivers the stop everywhere.
                werr.append(exc)
            worker.start()
        for bi, r0 in enumerate(range(rows_done, len(row_ids), band)):
            rids = row_ids[r0 : r0 + band]
            drids = row_denom_ids[r0 : r0 + band]
            nr = len(rids)
            rpad = np.pad(rids, (0, band - nr))
            # Chunk-invariant row operand: convert once per band, not once
            # per column chunk.
            ma = presence.m[:, rids].astype(np.float64) if use_host else None
            for ci, c0 in enumerate(range(0, len(col_ids), col_chunk)):
                cids = col_ids[c0 : c0 + col_chunk]
                dcids = col_denom_ids[c0 : c0 + col_chunk]
                nc = len(cids)
                if sym and ci < bi:
                    # Below the diagonal: no device work, no download — the
                    # worker mirrors the stored (ci, bi) tile.
                    if primary:
                        work_q.put(
                            (r0, rids, drids, c0, nc, dcids, "mirror",
                             (ci, bi))
                        )
                    if _abort():
                        aborted = True
                        break
                    continue
                if use_host:
                    mb = presence.m[:, cids].astype(np.float64)
                    payload = np.rint(ma @ mb.transpose(0, 2, 1)).astype(
                        np.int32
                    )
                else:
                    cpad = np.pad(cids, (0, col_chunk - nc))
                    payload = block_counts(rpad, cpad, band, col_chunk)
                    if multiproc:
                        # Cross-process gather: every process joins this
                        # collective (mesh counts shard over all hosts'
                        # devices); the primary keeps the materialized
                        # block for the finish worker.
                        payload = [
                            (idx, gather_to_host(dev))
                            for idx, dev in payload
                        ]
                    else:
                        for _, dev in payload:
                            if hasattr(dev, "copy_to_host_async"):
                                dev.copy_to_host_async()
                if not primary:
                    if _abort():
                        aborted = True
                        break
                    continue
                store_key = (bi, ci) if sym and ci > bi else None
                work_q.put(
                    (r0, rids, drids, c0, nc, dcids, "counts",
                     (payload, store_key))
                )
                if _abort():
                    aborted = True
                    break
            if aborted:
                break
    finally:
        if worker is not None and worker.is_alive():
            work_q.put(None)
            worker.join()
        if fp is not None:
            fp.close()
    if werr:
        raise werr[0]


def compute_sharded(
    presence: PresenceData,
    pairs: PairSpace,
    n_rows: int | None = None,
    n_scp: int = 1,
) -> JacResult:
    """Fused f32 path over an (n_rows, n_scp) device mesh (parallel/mesh.py).

    Genome row bands are data-parallel across ``rows``; the protein axis is
    sharded across ``scp`` with a psum merge.  Pads G / P to mesh multiples
    with zero genomes / empty proteins (zero rows give cnt == 0 -> masked).
    Two-database pair spaces (either compat setting) run the rectangular
    sharded kernel with denominator T columns gathered through
    PairSpace.row_denom_ids / col_denom_ids — the compat T-swap is honored
    on the mesh path, not silently dropped.
    """
    import jax

    from .parallel.distributed import gather_to_host
    from .parallel.mesh import (
        make_mesh,
        sharded_fused_sn,
        sharded_fused_sn_rect,
    )

    if n_rows is None:
        n_rows = max(1, jax.device_count() // n_scp)
    mesh = make_mesh(n_rows, n_scp)

    if not (
        np.array_equal(pairs.denom_a, pairs.db_a)
        and np.array_equal(pairs.denom_b, pairs.db_b)
    ) or _is_rect_pairs(pairs):
        if not _is_rect_pairs(pairs):
            raise ValueError(
                "compute_sharded: pair space is neither a single-id-space "
                "layout nor a rows x cols product"
            )
        ma = np.ascontiguousarray(presence.m[:, pairs.row_db_ids])
        mb = np.ascontiguousarray(presence.m[:, pairs.col_db_ids])
        ta = np.ascontiguousarray(presence.t[:, pairs.row_denom_ids])
        tb = np.ascontiguousarray(presence.t[:, pairs.col_denom_ids])
        P, A = ta.shape
        B = tb.shape[1]
        pp = -(-P // n_scp) * n_scp
        ap = -(-A // n_rows) * n_rows
        if (pp, ap) != (P, A):
            ma = np.pad(ma, ((0, pp - P), (0, ap - A), (0, 0)))
            ta = np.pad(ta, ((0, pp - P), (0, ap - A)))
            mb = np.pad(mb, ((0, pp - P), (0, 0), (0, 0)))
            tb = np.pad(tb, ((0, pp - P), (0, 0)))
        s_mat, n_mat = sharded_fused_sn_rect(mesh, ma, mb, ta, tb)
        s_mat = gather_to_host(s_mat)[:A]
        n_mat = gather_to_host(n_mat)[:A]
        return JacResult(
            genome_a=pairs.jac_a.astype(np.int32),
            genome_b=pairs.jac_b.astype(np.int32),
            s=s_mat.reshape(-1).astype(np.float64),
            n=n_mat.reshape(-1).astype(np.int32),
        )

    P, G, K = presence.m.shape
    pp = -(-P // n_scp) * n_scp
    gp = -(-G // n_rows) * n_rows
    m = presence.m
    t = presence.t
    if (pp, gp) != (P, G):
        m = np.pad(m, ((0, pp - P), (0, gp - G), (0, 0)))
        t = np.pad(t, ((0, pp - P), (0, gp - G)))
    s_mat, n_mat = sharded_fused_sn(mesh, m, t)
    s_mat = gather_to_host(s_mat)[:G, :G]
    n_mat = gather_to_host(n_mat)[:G, :G]
    return JacResult(
        genome_a=pairs.jac_a.astype(np.int32),
        genome_b=pairs.jac_b.astype(np.int32),
        s=s_mat[pairs.db_a, pairs.db_b].astype(np.float64),
        n=n_mat[pairs.db_a, pairs.db_b].astype(np.int32),
    )


def compute_fast(
    presence: PresenceData,
    pairs: PairSpace,
    staged: bool | None = None,
) -> JacResult:
    """Fused f32 device path; per-pair gather on device, minimal transfer.

    All-vs-all runs one full-square scan per width bucket with the presence
    resident on the device.  When the presence is staged (``staged``, or a
    tensor over the device budget; _use_staged) it runs as banded blocks
    that skip the lower triangle (_banded_sn) instead, fed from on-demand
    slabs.

    Two-database mode (either compat setting) runs a fully fused rectangular
    query x target block: the denominator T columns are gathered through
    PairSpace.row_denom_ids / col_denom_ids, which carry the reference's
    swapped-column read (modes.query_target) when compat is on.  This also
    computes only |Q| x |T| cells instead of the (|Q|+|T|)^2 square.
    """
    from .etl.database import bucketize_presence

    G = presence.m.shape[1]
    banded = _use_staged(presence, staged)
    if np.array_equal(pairs.denom_a, pairs.db_a) and np.array_equal(
        pairs.denom_b, pairs.db_b
    ):
        # Query-subset pair spaces are rectangular-reducible: every pair's A
        # side is a query genome, so the |Q| x G rectangle covers both slot
        # parts (Q x T' block and Q x Q triangle) — G/|Q| times less device
        # work and transfer than the G x G square (reference layout
        # ds_impl.hpp:251-263).
        rows = np.asarray(pairs.row_db_ids, np.int32)
        qsub_rect = (
            0 < len(rows) < G
            and np.array_equal(
                pairs.col_db_ids, np.arange(G, dtype=np.int32)
            )
            and bool(np.isin(pairs.db_a, rows).all())
        )
        if qsub_rect:
            qidx_of = np.full(G, -1, np.int32)
            qidx_of[rows] = np.arange(len(rows), dtype=np.int32)
            cols = np.arange(G, dtype=np.int32)
            s_mat, n_mat = _banded_sn(
                presence, rows, cols, rows, cols, staged=staged
            )
            s = s_mat[qidx_of[pairs.db_a], pairs.db_b].astype(np.float64)
            n = n_mat[qidx_of[pairs.db_a], pairs.db_b]
        # Staged presence: the streamed engine's banded block program,
        # assembled into host (G, G) S/N with the lower-triangle blocks
        # mirrored.  Width-bucketed execution inside (real databases'
        # per-protein widths vary ~10x; each bucket contracts at its own K).
        elif banded:
            ids = np.arange(G, dtype=np.int32)
            s_mat, n_mat = _banded_sn(
                presence, ids, ids, ids, ids, staged=staged
            )
            s = s_mat[pairs.db_a, pairs.db_b].astype(np.float64)
            n = n_mat[pairs.db_a, pairs.db_b]
        else:
            s_mat = n_mat = None
            for _, m_b, t_b in bucketize_presence(presence):
                s_b, n_b = fused_sn(upload_presence(m_b), jnp.asarray(t_b))
                s_mat = s_b if s_mat is None else s_mat + s_b
                n_mat = n_b if n_mat is None else n_mat + n_b
            if _is_triu_pairs(pairs, G):
                # Derive the pair indices ON device instead of uploading two
                # n_pairs-long int32 vectors (67 MB at G=4096).
                s_d, n_d = _gather_triu(s_mat, n_mat)
            else:
                a = jnp.asarray(pairs.db_a)
                b = jnp.asarray(pairs.db_b)
                s_d, n_d = s_mat[a, b], n_mat[a, b]
            # n <= P: download int16 when safe (halves the second transfer).
            if presence.m.shape[0] < 2**15:
                n_d = n_d.astype(jnp.int16)
            s = np.asarray(s_d, dtype=np.float64)
            n = np.asarray(n_d)
    elif _is_rect_pairs(pairs):
        rows, cols = pairs.row_db_ids, pairs.col_db_ids
        if banded:
            s_mat, n_mat = _banded_sn(
                presence,
                rows,
                cols,
                pairs.row_denom_ids,
                pairs.col_denom_ids,
                staged=staged,
            )
            # Pair slots are row-major rows x cols — a flatten matches.
            s = s_mat.reshape(-1).astype(np.float64)
            n = n_mat.reshape(-1)
        else:
            s_mat = n_mat = None
            for _, m_b, t_b in bucketize_presence(presence):
                ma = upload_presence(np.ascontiguousarray(m_b[:, rows]))
                mb = upload_presence(np.ascontiguousarray(m_b[:, cols]))
                ta = jnp.asarray(t_b[:, pairs.row_denom_ids])
                tb = jnp.asarray(t_b[:, pairs.col_denom_ids])
                s_b, n_b = fused_sn_block(ma, mb, ta, tb)
                s_mat = s_b if s_mat is None else s_mat + s_b
                n_mat = n_b if n_mat is None else n_mat + n_b
            s = np.asarray(s_mat, dtype=np.float64).reshape(-1)
            n = np.asarray(n_mat).reshape(-1)
    else:
        counts = np.asarray(
            pair_counts_device(
                upload_presence(presence.m),
                jnp.asarray(pairs.db_a),
                jnp.asarray(pairs.db_b),
            )
        )
        t = presence.t
        s64, n = jaccard_finish(
            counts, t[:, pairs.denom_a], t[:, pairs.denom_b]
        )
        s = s64
    return JacResult(
        genome_a=pairs.jac_a.astype(np.int32),
        genome_b=pairs.jac_b.astype(np.int32),
        s=np.asarray(s, dtype=np.float64),
        n=np.asarray(n, dtype=np.int32),
    )
