"""Staged (beyond-one-HBM) slab engines: genome capacity bounded by host
RAM, not device memory (the reference plans the same
memory batching in doc/pfaai_algorithm.tex:218-224 but never implements it).

The staged engines gather (band x K) presence slabs host-side and upload
them on demand through an LRU (engine._slab_store); forcing a tiny
PARFASTAAI_HBM_BYTES budget makes every block churn the LRU, exercising
upload, eviction, and reuse.  Results must match the resident engines —
bit-for-bit for the exact banded path (integer counts + the same f64
finish), byte-for-byte CSVs for the f32 streamed path (identical per-block
programs and accumulation order)."""

import numpy as np

from parfastaai_jax.engine import (
    _use_staged,
    compute,
    compute_fast,
    compute_streamed,
    compute_streamed_exact,
    presence_device_bytes,
)
from parfastaai_jax.etl.database import SCPDatabase
from parfastaai_jax.io.csv_writer import write_aji_csv
from parfastaai_jax.modes import all_vs_all, query_target


def _load(db_path):
    db = SCPDatabase(db_path)
    pres = db.load_presence()
    db.close()
    return db.meta, pres


def test_staged_streamed_matches_resident(subset1_db, tmp_path, monkeypatch):
    monkeypatch.setenv("PARFASTAAI_FORCE_DEVICE", "1")
    meta, pres = _load(subset1_db)
    g = len(meta.genome_set)
    ids = np.arange(g, dtype=np.int32)
    names = meta.genome_set

    resident = tmp_path / "resident.csv"
    compute_streamed(
        pres, ids, ids, str(resident), names, names, band=3, col_chunk=3,
        staged=False,
    )
    # Tiny budget: the LRU can never hold more than the two live slabs, so
    # every block re-fetches — the maximal-eviction stress case.
    monkeypatch.setenv("PARFASTAAI_HBM_BYTES", "1")
    staged = tmp_path / "staged.csv"
    compute_streamed(
        pres, ids, ids, str(staged), names, names, band=3, col_chunk=3,
        staged=True,
    )
    assert staged.read_bytes() == resident.read_bytes()


def test_staged_exact_banded_bit_parity(subset1_db, tmp_path, monkeypatch):
    """Staged integer counts + the same f64 finish => byte-identical CSV to
    the default exact path."""
    monkeypatch.setenv("PARFASTAAI_FORCE_DEVICE", "1")
    monkeypatch.setenv("PARFASTAAI_HBM_BYTES", "1")
    meta, pres = _load(subset1_db)
    pairs = all_vs_all(meta)
    want = tmp_path / "exact.csv"
    write_aji_csv(str(want), pairs, compute(pres, pairs).aji, ",")

    got = tmp_path / "staged_exact.csv"
    ids = np.arange(len(meta.genome_set), dtype=np.int32)
    compute_streamed_exact(
        pres, ids, ids, str(got), meta.genome_set, meta.genome_set,
        band=2, col_chunk=3, staged=True,
    )
    assert got.read_bytes() == want.read_bytes()


def test_staged_fast_qt_compat_denominators(subset1_db, subset2_db, tmp_path,
                                            monkeypatch):
    """The staged engine honors per-axis denominator columns (the two-DB
    compat T-swap) exactly like the resident one."""
    monkeypatch.setenv("PARFASTAAI_FORCE_DEVICE", "1")
    from parfastaai_jax.etl.database import QueryTargetDatabase

    db = QueryTargetDatabase(subset1_db, subset2_db)
    pres = db.load_presence()
    db.close()
    pairs = query_target(db.meta)  # compat swap on
    res = compute_fast(pres, pairs, staged=False)
    monkeypatch.setenv("PARFASTAAI_HBM_BYTES", "1")
    stg = compute_fast(pres, pairs, staged=True)
    np.testing.assert_array_equal(stg.n, res.n)
    np.testing.assert_array_equal(stg.s, res.s)  # identical f32 block math


def test_use_staged_resolution(subset1_db, monkeypatch):
    _, pres = _load(subset1_db)
    assert presence_device_bytes(pres) > 0
    # Explicit beats everything.
    assert _use_staged(pres, True) is True
    assert _use_staged(pres, False) is False
    # Env force.
    monkeypatch.setenv("PARFASTAAI_STAGED", "1")
    assert _use_staged(pres, None) is True
    monkeypatch.delenv("PARFASTAAI_STAGED")
    # Auto: tiny budget -> staged; huge budget -> resident.
    monkeypatch.setenv("PARFASTAAI_HBM_BYTES", "1")
    assert _use_staged(pres, None) is True
    monkeypatch.setenv("PARFASTAAI_HBM_BYTES", "1e18")
    assert _use_staged(pres, None) is False


def test_staged_env_zero_forces_resident(subset1_db, monkeypatch):
    """PARFASTAAI_STAGED=0 must force the RESIDENT engine (plain string
    truthiness read '0' as staged-on — the opposite of the request)."""
    from parfastaai_jax.engine import _use_staged
    from parfastaai_jax.etl.database import SCPDatabase

    db = SCPDatabase(subset1_db)
    pres = db.load_presence()
    db.close()
    monkeypatch.setenv("PARFASTAAI_HBM_BYTES", "1")  # auto would say staged
    monkeypatch.setenv("PARFASTAAI_STAGED", "0")
    assert _use_staged(pres) is False
    monkeypatch.setenv("PARFASTAAI_STAGED", "1")
    assert _use_staged(pres) is True


def test_cli_staged_combination_guards(subset1_db, tmp_path):
    """--staged without --fast/--streamed, or with --mesh but without
    --streamed, is a CONSTRUCT_ERROR (exit 3) — not a silently ignored
    flag.  (--staged --streamed --mesh is the staged-mesh path and valid.)"""
    import subprocess
    import sys

    out = str(tmp_path / "out.csv")
    for extra in (["--staged"], ["--staged", "--mesh", "1,1"]):
        r = subprocess.run(
            [sys.executable, "-m", "parfastaai_jax.cli", "--quiet",
             subset1_db, out] + extra,
            capture_output=True,
        )
        assert r.returncode == 3, (extra, r.stderr)
        assert not (tmp_path / "out.csv").exists()


def test_split_plan_bounds_slab_bytes(monkeypatch):
    """_split_plan subdivides a bucket's proteins so no staged slab exceeds
    the target at the given genome count — whole-P slabs of a wide bucket
    (4.4 GiB at P=80, band=1024, K=53248) piled past HBM with async
    dispatch's in-flight generation."""
    import numpy as np

    from parfastaai_jax.engine import _split_plan

    monkeypatch.setenv("PARFASTAAI_SLAB_BYTES", str(10_000))
    plan = [(np.arange(7, dtype=np.int32), 128),
            (np.arange(7, 80, dtype=np.int32), 4096)]
    out = list(_split_plan(plan, n_ids=64))
    # Every protein appears exactly once, in a chunk under the target.
    seen = np.concatenate([idx for _, _, idx, _ in out])
    np.testing.assert_array_equal(np.sort(seen), np.arange(80))
    for bi, pci, idx, kb in out:
        assert len(idx) * 64 * kb <= 10_000 or len(idx) == 1
    # Keys (bi, pci) are unique.
    keys = [(bi, pci) for bi, pci, _, _ in out]
    assert len(keys) == len(set(keys))


def _mesh(n_rows, n_scp):
    from parfastaai_jax.parallel.mesh import make_mesh

    return make_mesh(n_rows, n_scp)


def test_staged_mesh_streamed_matches_single_device_staged(
    subset1_db, tmp_path, monkeypatch
):
    """Staged x mesh composition: the streamed-mesh
    path fed from sharded slab fetches writes a byte-identical CSV to the
    single-device staged run on an 8-virtual-device CPU mesh."""
    monkeypatch.setenv("PARFASTAAI_FORCE_DEVICE", "1")
    meta, pres = _load(subset1_db)
    g = len(meta.genome_set)
    ids = np.arange(g, dtype=np.int32)
    names = meta.genome_set

    monkeypatch.setenv("PARFASTAAI_HBM_BYTES", "1")  # maximal LRU churn
    single = tmp_path / "single_staged.csv"
    compute_streamed(
        pres, ids, ids, str(single), names, names, band=4, col_chunk=3,
        staged=True,
    )
    # scp == 1: same per-chunk protein order per device => byte-identical.
    meshed = tmp_path / "mesh_staged.csv"
    compute_streamed(
        pres, ids, ids, str(meshed), names, names, band=4, col_chunk=3,
        mesh=_mesh(8, 1), staged=True,
    )
    assert meshed.read_bytes() == single.read_bytes()
    # scp > 1 splits each slab's protein scan across devices (psum merge),
    # reassociating the f32 sum — the fused paths' documented ~1e-7
    # contract, same as the resident mesh branch.
    meshed2 = tmp_path / "mesh_staged_scp2.csv"
    compute_streamed(
        pres, ids, ids, str(meshed2), names, names, band=4, col_chunk=3,
        mesh=_mesh(4, 2), staged=True,
    )
    got = np.genfromtxt(meshed2, delimiter=",", skip_header=1,
                        usecols=range(1, g + 1))
    want = np.genfromtxt(single, delimiter=",", skip_header=1,
                         usecols=range(1, g + 1))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_staged_mesh_qt_denominators(subset1_db, subset2_db, tmp_path,
                                     monkeypatch):
    """Staged-mesh honors per-axis denominator columns (two-DB compat
    T-swap): CSV equals the single-device staged streamed CSV."""
    monkeypatch.setenv("PARFASTAAI_FORCE_DEVICE", "1")
    from parfastaai_jax.etl.database import QueryTargetDatabase
    from parfastaai_jax.modes import query_target_axes

    db = QueryTargetDatabase(subset1_db, subset2_db)
    pres = db.load_presence()
    db.close()
    ax = query_target_axes(db.meta)
    monkeypatch.setenv("PARFASTAAI_HBM_BYTES", "1")
    single = tmp_path / "qt_single.csv"
    compute_streamed(
        pres, ax.row_db_ids, ax.col_db_ids, str(single), ax.query_names,
        ax.target_names, band=2, col_chunk=3, staged=True,
        row_denom_ids=ax.row_denom_ids, col_denom_ids=ax.col_denom_ids,
    )
    meshed = tmp_path / "qt_mesh.csv"
    compute_streamed(
        pres, ax.row_db_ids, ax.col_db_ids, str(meshed), ax.query_names,
        ax.target_names, band=2, col_chunk=3, staged=True,
        mesh=_mesh(2, 1),
        row_denom_ids=ax.row_denom_ids, col_denom_ids=ax.col_denom_ids,
    )
    assert meshed.read_bytes() == single.read_bytes()


def test_use_staged_mesh_scales_budget_with_scp(subset1_db, monkeypatch):
    """Auto staging on a mesh triggers against the scp-sharded per-device
    residency, not the whole-tensor figure."""
    from parfastaai_jax.engine import _use_staged_mesh

    _, pres = _load(subset1_db)
    per_dev = presence_device_bytes(pres)
    # Budget between total/4 and total: single-device would stage, a 4-way
    # scp mesh would not.
    monkeypatch.setenv("PARFASTAAI_HBM_BYTES", str(per_dev // 2))
    assert _use_staged_mesh(pres, n_scp=1) is True
    assert _use_staged_mesh(pres, n_scp=4) is False
    # Explicit always wins.
    assert _use_staged_mesh(pres, n_scp=1, staged=False) is False
    assert _use_staged_mesh(pres, n_scp=4, staged=True) is True


def _synth_presence(g=32, p=4, k=128, seed=0):
    from parfastaai_jax.etl.database import PresenceData
    from parfastaai_jax.types import DBMetaData

    rng = np.random.default_rng(seed)
    m = (rng.random((p, g, k)) < 0.3).astype(np.uint8)
    return PresenceData(
        meta=DBMetaData(
            protein_set=tuple(f"P{i}" for i in range(p)),
            genome_set=tuple(f"g{i:02d}" for i in range(g)),
        ),
        m=m,
        t=m.sum(axis=2, dtype=np.int32),
        widths=np.full(p, k, dtype=np.int32),
        tetramer_ids=[np.arange(k, dtype=np.int32) for _ in range(p)],
    )


def test_banded_sn_column_group_traversal_cuts_uploads(monkeypatch):
    """Reuse-aware staged traversal: the column-group
    walk re-ships materially fewer slab bytes than the old row-band-major
    walk under the same tight LRU, with identical results."""
    import parfastaai_jax.engine as eng

    monkeypatch.setenv("PARFASTAAI_FORCE_DEVICE", "1")
    # Budget chosen so the LRU holds ~3 slabs (4 KiB each) and the group
    # sizer picks 2 of the 4 column chunks per group.
    monkeypatch.setenv("PARFASTAAI_HBM_BYTES", "20000")
    ids = np.arange(32, dtype=np.int32)
    # Distinct denominator columns keep the walk NON-symmetric (the
    # symmetric triu skip would otherwise change both arms' block sets and
    # this test pins the traversal-order effect alone).
    dcol = (ids + 1) % 32

    def run(presence, group_fn=None):
        if group_fn is not None:
            monkeypatch.setattr(eng, "_staged_col_group", group_fn)
        out = eng._banded_sn(
            presence, ids, ids, ids, dcol, band=8, col_chunk=8, staged=True
        )
        fetch = presence._slab_store_cache[
            next(iter(presence._slab_store_cache))
        ]
        return out, fetch.uploaded_bytes()

    # Old behavior == one group spanning every chunk (row-band-major).
    (s_old, n_old), up_old = run(
        _synth_presence(), group_fn=lambda *a, **k: 4
    )
    monkeypatch.undo()
    monkeypatch.setenv("PARFASTAAI_FORCE_DEVICE", "1")
    monkeypatch.setenv("PARFASTAAI_HBM_BYTES", "20000")
    (s_new, n_new), up_new = run(_synth_presence())

    np.testing.assert_array_equal(n_new, n_old)
    np.testing.assert_array_equal(s_new, s_old)
    assert up_new < 0.75 * up_old, (up_new, up_old)


def test_staged_col_group_sizing(monkeypatch):
    from parfastaai_jax.engine import _staged_col_group

    pres = _synth_presence()  # per-genome slab bytes = 4 * 128 = 512
    monkeypatch.setenv("PARFASTAAI_HBM_BYTES", "20000")
    # Staged: cap 15000, band 8 -> avail 10904 -> 2 chunks of 8 genomes.
    assert _staged_col_group(pres, 8, 8, 4, True) == 2
    # Resident: single group (row-major walk).
    assert _staged_col_group(pres, 8, 8, 4, False) == 4
    # Budget too small for even one chunk: degrade to 1, never 0.
    monkeypatch.setenv("PARFASTAAI_HBM_BYTES", "1")
    assert _staged_col_group(pres, 8, 8, 4, True) == 1
