"""ETL parity: metadata, T matrix, presence tensors vs the bundled goldens
(mirrors the reference DB-layer unit tests, tests/pfaai_tests.cpp:122-171)."""

import sqlite3

import numpy as np
import pytest

from parfastaai_jax.etl import goldens as golden_io
from parfastaai_jax.etl.database import QueryTargetDatabase, SCPDatabase
from parfastaai_jax.types import PFAAIError


@pytest.mark.parametrize("name", ["xdb_subset1", "xdb_subset2"])
def test_t_matrix_matches_golden(goldens, name):
    db = SCPDatabase(f"{goldens}/{name}.db")
    t = db.load_t_matrix()
    ref = golden_io.read_dmatrix_i32(f"{goldens}/{name}_t_matrix.bin")
    np.testing.assert_array_equal(t, ref)
    db.close()


def test_metadata(subset1_db):
    import sqlite3

    conn = sqlite3.connect(subset1_db)
    n_scp = conn.execute("SELECT COUNT(DISTINCT SCP_acc) FROM scp_data").fetchone()[0]
    conn.close()
    db = SCPDatabase(subset1_db)
    assert len(db.meta.protein_set) == n_scp
    assert len(db.meta.genome_set) == 4
    assert all(n.endswith(".fna.gz") for n in db.meta.genome_set)
    db.close()


def test_presence_consistency(subset1_db, goldens):
    """Presence row sums must equal T (the '_genomes' and '_tetras' tables are
    mutually consistent, survey §7.2), and per-column sums reproduce Lc."""
    db = SCPDatabase(subset1_db)
    pres = db.load_presence()
    np.testing.assert_array_equal(
        pres.m.sum(axis=2, dtype=np.int32), pres.t
    )
    # Columns beyond each protein's width are all zero padding.
    for p in range(pres.n_proteins):
        assert pres.m[p, :, pres.widths[p] :].sum() == 0
        assert (pres.m[p, :, : pres.widths[p]].sum(axis=0) > 0).all()
    # Scatter per-protein column sums back to tetramer ids -> Lc.
    lc_ref = golden_io.read_i32_vector(f"{goldens}/xdb_subset1_lc_array.bin")
    lc = np.zeros(160000, dtype=np.int32)
    for p in range(pres.n_proteins):
        w = pres.widths[p]
        np.add.at(
            lc, pres.tetramer_ids[p], pres.m[p, :, :w].sum(axis=0, dtype=np.int32)
        )
    np.testing.assert_array_equal(lc, lc_ref)
    db.close()


def test_qt_metadata_and_t(subset1_db, subset2_db, goldens):
    db = QueryTargetDatabase(subset1_db, subset2_db)
    assert len(db.meta.protein_set) == 79
    assert len(db.meta.genome_set) == 4
    assert len(db.meta.query_genome_set) == 4
    t = db.load_t_matrix()
    ref = golden_io.read_dmatrix_i32(f"{goldens}/xdb_qt_t_matrix.bin")
    np.testing.assert_array_equal(t, ref)
    db.close()


def test_qt_presence_rowsums(subset1_db, subset2_db):
    db = QueryTargetDatabase(subset1_db, subset2_db)
    pres = db.load_presence()
    np.testing.assert_array_equal(pres.m.sum(axis=2, dtype=np.int32), pres.t)
    db.close()


def test_missing_db_raises():
    with pytest.raises(PFAAIError):
        SCPDatabase("/nonexistent/no.db")


def _copy_db(src, dst):
    import shutil

    shutil.copy(src, dst)
    return str(dst)


def test_corrupt_genome_id_rejected(subset1_db, tmp_path):
    """A tetramer blob with an out-of-range genome id must raise a clean
    PFAAIError, never reach the (unguarded) native scatter."""
    path = _copy_db(subset1_db, tmp_path / "corrupt.db")
    conn = sqlite3.connect(path)
    prot = conn.execute("SELECT DISTINCT SCP_acc FROM scp_data").fetchone()[0]
    tet = conn.execute(f"SELECT tetramer FROM '{prot}_tetras' LIMIT 1").fetchone()[0]
    bad = np.asarray([0, 9999], dtype="<i4").tobytes()
    conn.execute(f"UPDATE '{prot}_tetras' SET genomes=? WHERE tetramer=?", (bad, tet))
    conn.commit()
    conn.close()
    db = SCPDatabase(path)
    with pytest.raises(PFAAIError, match="genome id outside"):
        db.load_presence()
    db.close()


def test_malformed_blob_rejected(subset1_db, tmp_path):
    """A blob whose byte length is not a multiple of 4 must raise a clean
    PFAAIError from the reader."""
    path = _copy_db(subset1_db, tmp_path / "malformed.db")
    conn = sqlite3.connect(path)
    prot = conn.execute("SELECT DISTINCT SCP_acc FROM scp_data").fetchone()[0]
    tet = conn.execute(f"SELECT tetramer FROM '{prot}_tetras' LIMIT 1").fetchone()[0]
    conn.execute(
        f"UPDATE '{prot}_tetras' SET genomes=? WHERE tetramer=?", (b"abc", tet)
    )
    conn.commit()
    conn.close()
    db = SCPDatabase(path)
    with pytest.raises(PFAAIError, match="Failed reading protein"):
        db.load_presence()
    db.close()
