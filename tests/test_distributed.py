"""Sharded engine + CLI streamed/mesh flags on the 8-device CPU mesh."""

import csv

import numpy as np

from parfastaai_jax.cli import run
from parfastaai_jax.engine import compute, compute_sharded
from parfastaai_jax.etl.database import SCPDatabase
from parfastaai_jax.modes import all_vs_all


def _load(path):
    db = SCPDatabase(path)
    pres = db.load_presence()
    db.close()
    return db.meta, pres


def _read_csv(path):
    with open(path) as fp:
        rows = list(csv.reader(fp))
    return rows[0][1:], [r[0] for r in rows[1:]], np.array(
        [[float(v) for v in r[1:]] for r in rows[1:]]
    )


def test_compute_sharded_matches_exact(combo12_db):
    """8 genomes over a 4x2 (rows x scp) mesh with G and P padding
    (8 % 4 == 0, 80 % 2 == 0; then again on a 3-row mesh forcing G pad)."""
    meta, pres = _load(combo12_db)
    pairs = all_vs_all(meta)
    exact = compute(pres, pairs)
    for n_rows, n_scp in ((4, 2), (3, 1)):
        got = compute_sharded(pres, pairs, n_rows=n_rows, n_scp=n_scp)
        np.testing.assert_array_equal(got.n, exact.n)
        np.testing.assert_allclose(got.aji, exact.aji, rtol=1e-6)


def test_cli_mesh_flag_matches_exact(combo12_db, tmp_path):
    exact_csv = tmp_path / "exact.csv"
    mesh_csv = tmp_path / "mesh.csv"
    assert run([combo12_db, str(exact_csv), "--quiet"]) == 0
    assert run([combo12_db, str(mesh_csv), "--quiet", "--mesh", "4,2"]) == 0
    _, _, want = _read_csv(str(exact_csv))
    names, rows, got = _read_csv(str(mesh_csv))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_streamed_over_mesh_matches_single(combo12_db, tmp_path, monkeypatch):
    """Streamed path with row bands sharded over a 4-device mesh must produce
    the identical CSV to the single-device streamed path."""
    from parfastaai_jax.engine import compute_streamed
    from parfastaai_jax.parallel.mesh import make_mesh

    monkeypatch.setenv("PARFASTAAI_FORCE_DEVICE", "1")
    meta, pres = _load(combo12_db)
    g = len(meta.genome_set)
    ids = np.arange(g, dtype=np.int32)
    single = tmp_path / "single.csv"
    meshed = tmp_path / "meshed.csv"
    compute_streamed(
        pres, ids, ids, str(single), meta.genome_set, meta.genome_set,
        band=4, col_chunk=8,
    )
    compute_streamed(
        pres, ids, ids, str(meshed), meta.genome_set, meta.genome_set,
        band=4, col_chunk=8, mesh=make_mesh(4),
    )
    assert meshed.read_bytes() == single.read_bytes()


def test_cli_streamed_all_modes(combo12_db, subset1_db, subset2_db, tmp_path):
    """--streamed output matches the exact CSV (f32 tolerance) in all three
    modes, with tiny bands to exercise the block loops."""
    # all-vs-all
    e1, s1 = tmp_path / "e1.csv", tmp_path / "s1.csv"
    assert run([combo12_db, str(e1), "--quiet"]) == 0
    assert run(
        [combo12_db, str(s1), "--quiet", "--streamed", "--band", "3",
         "--col-chunk", "5"]
    ) == 0
    _, _, want = _read_csv(str(e1))
    _, _, got = _read_csv(str(s1))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)

    # query-subset
    qfile = tmp_path / "q.txt"
    meta, _ = _load(combo12_db)
    qfile.write_text(meta.genome_set[0] + "\n" + meta.genome_set[5] + "\n")
    e2, s2 = tmp_path / "e2.csv", tmp_path / "s2.csv"
    assert run([combo12_db, str(e2), "--quiet", "-q", str(qfile)]) == 0
    assert run(
        [combo12_db, str(s2), "--quiet", "-q", str(qfile), "--streamed",
         "--band", "1", "--col-chunk", "3"]
    ) == 0
    _, _, want = _read_csv(str(e2))
    _, _, got = _read_csv(str(s2))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)

    # two-database: streamed honors the denominator T columns of the pair
    # space, so it must match the exact engine under BOTH compat settings.
    for extra in ([], ["--no-compat-qt-t-swap"]):
        e3 = tmp_path / f"e3{len(extra)}.csv"
        s3 = tmp_path / f"s3{len(extra)}.csv"
        assert run(
            [subset1_db, str(e3), "--quiet", "-r", subset2_db] + extra
        ) == 0
        assert run(
            [subset1_db, str(s3), "--quiet", "-r", subset2_db, "--streamed",
             "--band", "2", "--col-chunk", "3"] + extra
        ) == 0
        _, _, want = _read_csv(str(e3))
        _, _, got = _read_csv(str(s3))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_qt_compat_on_every_device_path(subset1_db, subset2_db):
    """--fast and --mesh must honor the two-database compat T-swap (and the
    corrected denominators with compat off) instead of silently falling
    back to a single-device exact run."""
    from parfastaai_jax.engine import compute_fast
    from parfastaai_jax.etl.database import QueryTargetDatabase
    from parfastaai_jax.modes import query_target

    db = QueryTargetDatabase(subset1_db, subset2_db)
    pres = db.load_presence()
    db.close()
    for compat in (True, False):
        pairs = query_target(db.meta, compat_qt_t_swap=compat)
        exact = compute(pres, pairs)
        fast = compute_fast(pres, pairs)
        np.testing.assert_array_equal(fast.n, exact.n)
        np.testing.assert_allclose(fast.s, exact.s, rtol=1e-6)
        sharded = compute_sharded(pres, pairs, n_rows=2, n_scp=2)
        np.testing.assert_array_equal(sharded.n, exact.n)
        np.testing.assert_allclose(sharded.s, exact.s, rtol=1e-6)


def test_streamed_mesh_rows_scp(combo12_db, tmp_path, monkeypatch):
    """--streamed --mesh ROWS,SCP uses both axes.
    rows-only sharding is bit-equal to single-device; adding the scp axis
    reassociates the f32 protein sum (psum merge) so it gets a tolerance."""
    from parfastaai_jax.engine import compute_streamed
    from parfastaai_jax.parallel.mesh import make_mesh

    monkeypatch.setenv("PARFASTAAI_FORCE_DEVICE", "1")
    meta, pres = _load(combo12_db)
    g = len(meta.genome_set)
    ids = np.arange(g, dtype=np.int32)
    outs = {}
    for name, mesh in (
        ("single", None),
        ("r4s1", make_mesh(4, 1)),
        ("r4s2", make_mesh(4, 2)),
    ):
        path = tmp_path / f"{name}.csv"
        compute_streamed(
            pres, ids, ids, str(path), meta.genome_set, meta.genome_set,
            band=4, col_chunk=8, mesh=mesh,
        )
        outs[name] = path
    assert outs["r4s1"].read_bytes() == outs["single"].read_bytes()
    _, _, want = _read_csv(str(outs["single"]))
    _, _, got = _read_csv(str(outs["r4s2"]))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_meta_only_stub_raises_on_data_access():
    """MetaOnlyM (the meta-only broadcast's presence stand-in) exposes shape
    and dtype for the routing arithmetic but raises PFAAIError on any data
    access — a silently-zero tensor would corrupt results, a loud error
    cannot."""
    import numpy as np
    import pytest

    from parfastaai_jax.etl.database import MetaOnlyM
    from parfastaai_jax.types import PFAAIError

    stub = MetaOnlyM((3, 5, 7))
    assert stub.shape == (3, 5, 7)
    assert stub.dtype == np.uint8
    assert stub.nbytes == 3 * 5 * 7
    with pytest.raises(PFAAIError):
        stub[0]
    with pytest.raises(PFAAIError):
        stub.astype(np.float64)
    with pytest.raises(PFAAIError):
        np.asarray(stub)
    with pytest.raises(PFAAIError):
        stub.sum(axis=2)
