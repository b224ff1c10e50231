"""Subset-DB builder (tools/subset_db.py) vs the fixture databases.

The combo12 fixture contains the union of subset1's and subset2's genomes
(reference data/subset_db.py:282-307), with subset1's four genomes first —
so building a 4-genome subset of combo12 with subset1's names must
reproduce subset1's content exactly (both come from the same master with
the same remap semantics)."""

import sqlite3

import numpy as np
import pytest

from parfastaai_jax.tools.subset_db import build_subset_db

@pytest.fixture(scope="module")
def subset1_names(subset1_db):
    return [r[0] for r in _rows(subset1_db, "SELECT genome_name FROM genome_metadata")]


@pytest.fixture(scope="module")
def built_subset1(tmp_path_factory, combo12_db, subset1_names):
    dst = tmp_path_factory.mktemp("subsetdb") / "rebuilt_subset1.db"
    build_subset_db(combo12_db, str(dst), subset1_names)
    return str(dst)


def _rows(path, query):
    conn = sqlite3.connect(f"file:{path}?mode=ro", uri=True)
    try:
        return conn.execute(query).fetchall()
    finally:
        conn.close()


def test_metadata_tables_match(built_subset1, subset1_db):
    for q in (
        "SELECT * FROM genome_metadata ORDER BY genome_id",
        "SELECT * FROM scp_data ORDER BY genome_id, SCP_acc",
        "SELECT * FROM index_protein ORDER BY protein_number",
        "SELECT * FROM protein_index ORDER BY protein_string",
    ):
        assert _rows(built_subset1, q) == _rows(subset1_db, q)


def test_all_scp_tables_match(built_subset1, subset1_db):
    prots = [r[0] for r in _rows(subset1_db, "SELECT DISTINCT SCP_acc FROM scp_data")]
    assert prots
    for prot in prots:
        for tbl, key in ((f"'{prot}_tetras'", "tetramer"), (f"'{prot}_genomes'", "genome_id")):
            q = f"SELECT * FROM {tbl} ORDER BY {key}"
            assert _rows(built_subset1, q) == _rows(subset1_db, q), tbl


def test_engine_on_built_subset_matches_golden(
    built_subset1, subset1_csv, tmp_path
):
    """End-to-end: run the CLI over the rebuilt subset DB; the AJI CSV must be
    byte-identical to subset1's golden CSV."""
    from parfastaai_jax.cli import run

    out = tmp_path / "aji.csv"
    assert run([built_subset1, str(out), "--quiet"]) == 0
    assert out.read_bytes() == subset1_csv


def test_missing_genome_rejected(combo12_db, tmp_path):
    with pytest.raises(ValueError, match="NOT_A_GENOME"):
        build_subset_db(
            combo12_db, str(tmp_path / "x.db"), ["NOT_A_GENOME"]
        )


def test_refuses_overwrite(combo12_db, subset1_names, tmp_path):
    dst = tmp_path / "exists.db"
    dst.write_bytes(b"")
    with pytest.raises(FileExistsError):
        build_subset_db(combo12_db, str(dst), subset1_names)


def test_rebuild_roundtrip_on_synthetic_db(tmp_path):
    """rebuild_master_db is generic: deriving F/Lc from any database and
    rebuilding reproduces the engine-visible tables exactly (not just the
    xanthodb fixtures)."""
    import sqlite3

    import numpy as np

    from parfastaai_jax.etl.database import SCPDatabase
    from parfastaai_jax.etl.derive import derive_single
    from parfastaai_jax.tools.rebuild_master_db import rebuild_master_db
    from parfastaai_jax.tools.synth_db import generate

    src = str(tmp_path / "synth.db")
    generate(src, n_genomes=9, n_proteins=5, pool_size=300,
             tetras_per_genome=120, seed=3)
    db = SCPDatabase(src)
    lc, _, f, _ = derive_single(db)
    names = list(db.meta.genome_set)
    prots = list(db.meta.protein_set)
    db.close()

    # Write the goldens the tool consumes (cereal vector layout).
    import struct

    def write_vec(path, arr):
        with open(path, "wb") as fp:
            fp.write(struct.pack("<Q", arr.shape[0]))
            fp.write(np.ascontiguousarray(arr, dtype="<i4").tobytes())

    f_bin = str(tmp_path / "f.bin")
    lc_bin = str(tmp_path / "lc.bin")
    write_vec(f_bin, f)
    write_vec(lc_bin, lc)

    dst = str(tmp_path / "rebuilt.db")
    rebuild_master_db(dst, f_bin, lc_bin, names, prots, donor_dbs=[src])

    a = sqlite3.connect(f"file:{src}?mode=ro", uri=True)
    b = sqlite3.connect(f"file:{dst}?mode=ro", uri=True)
    try:
        assert [r[0] for r in a.execute("SELECT DISTINCT SCP_acc FROM scp_data")] == [
            r[0] for r in b.execute("SELECT DISTINCT SCP_acc FROM scp_data")
        ]
        assert list(a.execute("SELECT genome_name, genome_id FROM genome_metadata")) == list(
            b.execute("SELECT genome_name, genome_id FROM genome_metadata")
        )
        for prot in prots:
            for table, key in (
                (f"{prot}_tetras", "tetramer"),
                (f"{prot}_genomes", "genome_id"),
            ):
                assert list(a.execute(f"SELECT * FROM '{table}' ORDER BY {key}")) == list(
                    b.execute(f"SELECT * FROM '{table}' ORDER BY {key}")
                ), table
    finally:
        a.close()
        b.close()
