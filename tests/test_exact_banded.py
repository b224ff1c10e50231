"""Streamed banded EXACT engine: bit-parity f64 AJI at
bounded memory.  The acceptance bar is BYTE-identical CSV output vs the
default exact path (compute + write_aji_csv) on every mode, through both the
host-BLAS and device count paths, with odd band/col_chunk shapes that force
padding and multi-block assembly."""

import numpy as np
import pytest

from parfastaai_jax.engine import (
    compute,
    compute_streamed_exact,
    jaccard_finish,
    jaccard_finish_block,
)
from parfastaai_jax.etl.database import QueryTargetDatabase, SCPDatabase
from parfastaai_jax.io.csv_writer import write_aji_csv
from parfastaai_jax.modes import (
    all_vs_all,
    all_vs_all_axes,
    query_subset,
    query_subset_axes,
    query_target,
    query_target_axes,
)


def _exact_csv(tmp_path, presence, pairs, name):
    out = tmp_path / f"{name}_ref.csv"
    write_aji_csv(str(out), pairs, compute(presence, pairs).aji)
    return out.read_bytes()


def _banded_csv(tmp_path, presence, axes, name, **kw):
    out = tmp_path / f"{name}_banded.csv"
    compute_streamed_exact(
        presence,
        axes.row_db_ids,
        axes.col_db_ids,
        str(out),
        axes.query_names,
        axes.target_names,
        row_denom_ids=axes.row_denom_ids,
        col_denom_ids=axes.col_denom_ids,
        **kw,
    )
    return out.read_bytes()


@pytest.fixture(scope="module")
def combo(combo12_db):
    db = SCPDatabase(combo12_db)
    pres = db.load_presence()
    db.close()
    return db.meta, pres


@pytest.mark.parametrize("band,col_chunk", [(512, 2048), (3, 2)])
def test_all_vs_all_byte_identical(combo, tmp_path, band, col_chunk):
    meta, pres = combo
    ref = _exact_csv(tmp_path, pres, all_vs_all(meta), "ava")
    got = _banded_csv(
        tmp_path, pres, all_vs_all_axes(meta), "ava",
        band=band, col_chunk=col_chunk,
    )
    assert got == ref


def test_all_vs_all_device_counts_byte_identical(combo, tmp_path, monkeypatch):
    """Force the device (CPU-backend jit) count path — integer counts are
    exact on any backend, so bytes must not change."""
    meta, pres = combo
    monkeypatch.setenv("PARFASTAAI_FORCE_DEVICE", "1")
    ref = _exact_csv(tmp_path, pres, all_vs_all(meta), "avad")
    got = _banded_csv(
        tmp_path, pres, all_vs_all_axes(meta), "avad", band=3, col_chunk=5
    )
    assert got == ref


def test_query_subset_byte_identical(combo, tmp_path):
    meta, pres = combo
    queries = [meta.genome_set[i] for i in (5, 0, 2)]
    ref = _exact_csv(tmp_path, pres, query_subset(meta, queries), "qs")
    got = _banded_csv(
        tmp_path, pres, query_subset_axes(meta, queries), "qs",
        band=2, col_chunk=3,
    )
    assert got == ref


@pytest.mark.parametrize("compat", [True, False])
def test_query_target_byte_identical(
    subset1_db, subset2_db, tmp_path, compat
):
    db = QueryTargetDatabase(subset1_db, subset2_db)
    pres = db.load_presence()
    db.close()
    ref = _exact_csv(
        tmp_path, pres, query_target(db.meta, compat_qt_t_swap=compat),
        f"qt{compat}",
    )
    got = _banded_csv(
        tmp_path, pres, query_target_axes(db.meta, compat_qt_t_swap=compat),
        f"qt{compat}", band=3, col_chunk=2,
    )
    assert got == ref


def test_resume_completes_identically(combo, tmp_path):
    meta, pres = combo
    axes = all_vs_all_axes(meta)
    full = _banded_csv(tmp_path, pres, axes, "full", band=2)
    # Interrupt after 2 bands (4 rows) + a torn partial line.
    out = tmp_path / "resume.csv"
    lines = full.split(b"\n")
    out.write_bytes(b"\n".join(lines[:5]) + b"\ngarbage_partial")
    compute_streamed_exact(
        pres, axes.row_db_ids, axes.col_db_ids, str(out),
        axes.query_names, axes.target_names, band=2, resume=True,
    )
    assert out.read_bytes() == full


def test_finish_block_matches_pairwise_finish():
    """jaccard_finish_block == jaccard_finish on the equivalent flattened
    pair list (both the native kernel and the NumPy fallback share the
    ascending-protein f64 order)."""
    rng = np.random.default_rng(3)
    P, A, B = 7, 5, 9
    counts = rng.integers(0, 50, (P, A, B)).astype(np.int32)
    counts[rng.random((P, A, B)) < 0.3] = 0
    ta = rng.integers(50, 200, (P, A)).astype(np.int32)
    tb = rng.integers(50, 200, (P, B)).astype(np.int32)
    s_blk, n_blk = jaccard_finish_block(counts, ta, tb)
    flat = counts.reshape(P, A * B)
    ta_full = np.repeat(ta, B, axis=1)
    tb_full = np.tile(tb, (1, A))
    s_ref, n_ref = jaccard_finish(flat, ta_full, tb_full)
    np.testing.assert_array_equal(s_blk.reshape(-1), s_ref)
    np.testing.assert_array_equal(n_blk.reshape(-1), n_ref)
    # int16 counts (the device wire format) give identical results.
    s16, n16 = jaccard_finish_block(counts.astype(np.int16), ta, tb)
    np.testing.assert_array_equal(s16, s_blk)
    np.testing.assert_array_equal(n16, n_blk)


def test_nan_semantics_match_exact_path(tmp_path):
    """A genome pair sharing no protein prints nan via both engines
    (reference 0/0 -> NaN, algorithm_impl.hpp:318)."""
    from parfastaai_jax.etl.database import PresenceData
    from parfastaai_jax.types import DBMetaData

    meta = DBMetaData(protein_set=("P1",), genome_set=("a", "b", "c"))
    m = np.zeros((1, 3, 128), np.uint8)
    m[0, 0, :4] = 1  # genome a has tetramers; b shares none; c empty
    m[0, 1, 4:8] = 1
    pres = PresenceData(
        meta=meta, m=m, t=m.sum(2).astype(np.int32),
        widths=np.array([8], np.int32),
        tetramer_ids=[np.arange(8, dtype=np.int32)],
    )
    pairs = all_vs_all(meta)
    ref = _exact_csv(tmp_path, pres, pairs, "nan")
    assert b"nan" in ref  # sanity: the case is actually exercised
    got = _banded_csv(tmp_path, pres, all_vs_all_axes(meta), "nan", band=1)
    assert got == ref


def test_symmetric_mirror_reuse_byte_identical(
    subset1_db, tmp_path, monkeypatch
):
    """All-vs-all banded exact runs compute only diagonal-and-above blocks
    and mirror the rest (r4): bytes must equal the full-square walk
    (PARFASTAAI_MIRROR_BYTES=1 disables the reuse) at awkward band sizes."""
    import numpy as np

    from parfastaai_jax.engine import compute_streamed_exact
    from parfastaai_jax.etl.database import SCPDatabase

    db = SCPDatabase(subset1_db)
    pres = db.load_presence()
    db.close()
    g = len(db.meta.genome_set)
    ids = np.arange(g, dtype=np.int32)
    names = db.meta.genome_set
    for band in (1, 3):  # band 3 leaves a short trailing band at g=4
        mirrored = tmp_path / f"sym{band}.csv"
        compute_streamed_exact(
            pres, ids, ids, str(mirrored), names, names, band=band,
            col_chunk=2 * band,  # sym forces col_chunk = band internally
        )
        monkeypatch.setenv("PARFASTAAI_MIRROR_BYTES", "1")
        full = tmp_path / f"full{band}.csv"
        compute_streamed_exact(
            pres, ids, ids, str(full), names, names, band=band,
            col_chunk=band,
        )
        monkeypatch.delenv("PARFASTAAI_MIRROR_BYTES")
        assert mirrored.read_bytes() == full.read_bytes()


@pytest.mark.parametrize(
    "rows,scp,staged",
    [(1, 1, None), (2, 2, None), (4, 2, None), (2, 2, True), (4, 1, True)],
)
def test_exact_mesh_byte_identical(combo, tmp_path, rows, scp, staged):
    """Mesh-parallel banded exact: count production
    sharded over a (rows, scp) mesh — resident and staged — is byte-equal to
    the dense exact path.  Odd band/col_chunk force row padding (band 3 on a
    rows=2/4 axis rounds up) and multi-block assembly."""
    meta, pres = combo
    from parfastaai_jax.parallel.mesh import make_mesh

    ref = _exact_csv(tmp_path, pres, all_vs_all(meta), f"m{rows}{scp}")
    got = _banded_csv(
        tmp_path, pres, all_vs_all_axes(meta), f"m{rows}{scp}",
        band=3, col_chunk=5, mesh=make_mesh(rows, scp), staged=staged,
    )
    assert got == ref


def test_exact_mesh_qt_compat_swap(subset1_db, subset2_db, tmp_path):
    """The two-database compat T-swap rides through the mesh count path:
    denominator columns are finish-side (host), so any sharding of the
    counts must leave the swapped bytes unchanged."""
    from parfastaai_jax.parallel.mesh import make_mesh

    db = QueryTargetDatabase(subset1_db, subset2_db)
    pres = db.load_presence()
    db.close()
    for compat in (True, False):
        ref = _exact_csv(
            tmp_path, pres, query_target(db.meta, compat_qt_t_swap=compat),
            f"qtm{compat}",
        )
        got = _banded_csv(
            tmp_path, pres,
            query_target_axes(db.meta, compat_qt_t_swap=compat),
            f"qtm{compat}", band=3, col_chunk=2, mesh=make_mesh(2, 2),
        )
        assert got == ref


def test_exact_mesh_resume(combo, tmp_path):
    """--resume through the mesh engine: band-aligned truncation + restart
    finishes byte-identical (the broadcast/resume contract holds when only
    one process exists, and the rounded band stays the checkpoint unit)."""
    from parfastaai_jax.parallel.mesh import make_mesh

    meta, pres = combo
    axes = all_vs_all_axes(meta)
    mesh = make_mesh(2, 1)
    full = _banded_csv(
        tmp_path, pres, axes, "mfull", band=2, col_chunk=3, mesh=mesh
    )
    out = tmp_path / "mresume.csv"
    lines = full.split(b"\n")
    out.write_bytes(b"\n".join(lines[:5]) + b"\ntorn_partial")
    compute_streamed_exact(
        pres, axes.row_db_ids, axes.col_db_ids, str(out),
        axes.query_names, axes.target_names, band=2, col_chunk=3,
        resume=True, mesh=mesh,
    )
    assert out.read_bytes() == full


def test_exact_abort_mid_band_discards_partial_band(
    subset1_db, tmp_path, monkeypatch
):
    """Producer abort mid-band (device error, interrupt) must NOT write the
    partially-filled band: its unfilled chunks are uninitialized memory, and
    --resume would keep a written band as a valid checkpoint (r4 review
    finding).  The aborted CSV holds only complete bands; a --resume rerun
    finishes it byte-identical to a clean run."""
    import numpy as np
    import pytest

    import parfastaai_jax.engine as eng
    from parfastaai_jax.etl.database import SCPDatabase

    monkeypatch.setenv("PARFASTAAI_FORCE_DEVICE", "1")
    db = SCPDatabase(subset1_db)
    pres = db.load_presence()
    db.close()
    g = len(db.meta.genome_set)
    ids = np.arange(g, dtype=np.int32)
    names = db.meta.genome_set

    clean = tmp_path / "clean.csv"
    eng.compute_streamed_exact(
        pres, ids, ids, str(clean), names, names, band=2, col_chunk=2
    )

    calls = []
    orig = eng._bucket_count_engine

    def failing(presence):
        block_counts = orig(presence)

        def wrapped(*a, **k):
            calls.append(1)
            if len(calls) == 3:  # band 2, chunk 1: abort mid-band
                raise RuntimeError("injected device failure")
            return block_counts(*a, **k)

        return wrapped

    monkeypatch.setattr(eng, "_bucket_count_engine", failing)
    out = tmp_path / "aborted.csv"
    # Fresh presence object: the count engine is cached per presence.
    db = SCPDatabase(subset1_db)
    pres2 = db.load_presence()
    db.close()
    with pytest.raises(RuntimeError, match="injected"):
        eng.compute_streamed_exact(
            pres2, ids, ids, str(out), names, names, band=2, col_chunk=2
        )
    lines = out.read_text().splitlines()
    assert len(lines) == 1 + 2, lines  # header + ONLY the complete band
    monkeypatch.setattr(eng, "_bucket_count_engine", orig)
    eng.compute_streamed_exact(
        pres, ids, ids, str(out), names, names, band=2, col_chunk=2,
        resume=True,
    )
    assert out.read_bytes() == clean.read_bytes()
