"""The rebuilt 20-genome master database vs every surviving xanthodb golden.

The reference checkout strips the master DB (/root/reference/
.MISSING_LARGE_BLOBS), but its complete inverted index survives as
xanthodb_f_array.bin + xanthodb_lc_array.bin, so
tools/rebuild_master_db.py reconstructs a semantically identical database
— unlocking the xanthodb all-vs-all goldens (190 pairs), the query-subset
goldens (85 pairs), the per-pair E extents, and the recorded 8-thread E-slab
layout, none of which are reachable from the subset DBs alone."""

import filecmp
import sqlite3

import numpy as np
import pytest

from parfastaai_jax.engine import compute
from parfastaai_jax.etl import goldens as golden_io
from parfastaai_jax.etl.database import SCPDatabase
from parfastaai_jax.etl.derive import (
    derive_pair_extents,
    derive_single,
    derive_thread_slabs,
)
from parfastaai_jax.io.csv_writer import write_aji_csv
from parfastaai_jax.modes import all_vs_all, query_subset
from parfastaai_jax.tools.rebuild_master_db import (
    genome_names_from_csv_header,
    protein_names_from_db,
    rebuild_master_db,
)
from parfastaai_jax.tools.subset_db import build_subset_db

# The master's 80th protein is absent from every bundled subset DB; its name
# and last-place DISTINCT position come from the reference's own fixture
# (tests/pfaai_tests.hpp TESTDB_PROTEIN_SET, final element).
EXTRA_PROTEIN = "PF01139.17"


@pytest.fixture(scope="session")
def master_db(tmp_path_factory, goldens, subset1_db, subset2_db, combo12_db):
    path = str(tmp_path_factory.mktemp("master") / "xanthodb_rebuilt.db")
    names = genome_names_from_csv_header(
        f"{goldens}/xanthodb_aji_matrix_wheader.csv"
    )
    prots = protein_names_from_db(subset1_db) + [EXTRA_PROTEIN]
    rebuild_master_db(
        path,
        f"{goldens}/xanthodb_f_array.bin",
        f"{goldens}/xanthodb_lc_array.bin",
        names,
        prots,
        donor_dbs=[subset1_db, subset2_db, combo12_db],
    )
    return path


@pytest.fixture(scope="session")
def master(master_db):
    db = SCPDatabase(master_db)
    pres = db.load_presence()
    db.close()
    return db.meta, pres


def test_metadata(master):
    meta, pres = master
    assert len(meta.genome_set) == 20
    assert len(meta.protein_set) == 80
    assert meta.protein_set[-1] == EXTRA_PROTEIN
    assert pres.m.shape[:2] == (80, 20)


def test_t_matrix_golden(master_db, goldens):
    db = SCPDatabase(master_db)
    t = db.load_t_matrix()
    db.close()
    golden = golden_io.read_dmatrix_i32(f"{goldens}/xanthodb_t_matrix.bin")
    np.testing.assert_array_equal(t, golden)


def test_lc_lp_f_roundtrip(master_db, goldens):
    """Re-deriving the reference arrays from the rebuilt DB reproduces the
    goldens they were built from."""
    db = SCPDatabase(master_db)
    lc, lp, f, e = derive_single(db)
    db.close()
    np.testing.assert_array_equal(
        lc, golden_io.read_i32_vector(f"{goldens}/xanthodb_lc_array.bin")
    )
    np.testing.assert_array_equal(
        lp, golden_io.read_i32_vector(f"{goldens}/xanthodb_lp_array.bin")
    )
    np.testing.assert_array_equal(
        f, golden_io.read_pair_vector(f"{goldens}/xanthodb_f_array.bin")
    )
    # The sorted E golden itself is stripped, but its recorded size survives
    # in the 8-thread slab layout (sizes sum to |E|).
    e_size = golden_io.read_i32_vector(f"{goldens}/xanthodb_e_size.bin")
    assert len(e) == int(e_size.sum())


def test_aji_jac_bit_for_bit(master, goldens):
    meta, pres = master
    pairs = all_vs_all(meta)
    res = compute(pres, pairs)
    jac = golden_io.read_jac_vector(f"{goldens}/xanthodb_jac.bin")
    aji = golden_io.read_f64_vector(f"{goldens}/xanthodb_aji.bin")
    assert res.n_pairs == 190
    np.testing.assert_array_equal(res.genome_a, jac["genome_a"])
    np.testing.assert_array_equal(res.genome_b, jac["genome_b"])
    np.testing.assert_array_equal(res.s, jac["s"])  # exact f64
    np.testing.assert_array_equal(res.n, jac["n"])
    np.testing.assert_array_equal(res.aji, aji)  # exact f64


def test_csv_byte_equal(master, goldens, tmp_path):
    meta, pres = master
    pairs = all_vs_all(meta)
    res = compute(pres, pairs)
    out = str(tmp_path / "xanthodb.csv")
    write_aji_csv(out, pairs, res.aji)
    assert filecmp.cmp(
        out, f"{goldens}/xanthodb_aji_matrix_wheader.csv", shallow=False
    )


def test_query_subset_goldens(master, goldens, tmp_path):
    """The 5-query run (qsub_test_input.txt): JAC/AJI bins and the output CSV,
    all bit-for-bit."""
    meta, pres = master
    with open(f"{goldens}/qsub_test_input.txt") as fp:
        queries = fp.read().split()
    pairs = query_subset(meta, queries)
    res = compute(pres, pairs)
    jac = golden_io.read_jac_vector(f"{goldens}/xdb_qry_subset_jac.bin")
    aji = golden_io.read_f64_vector(f"{goldens}/xdb_qry_subset_aji.bin")
    assert res.n_pairs == 85  # 5*15 + C(5,2)
    np.testing.assert_array_equal(res.genome_a, jac["genome_a"])
    np.testing.assert_array_equal(res.genome_b, jac["genome_b"])
    np.testing.assert_array_equal(res.s, jac["s"])
    np.testing.assert_array_equal(res.n, jac["n"])
    np.testing.assert_array_equal(res.aji, aji)

    out = str(tmp_path / "qsub.csv")
    write_aji_csv(out, pairs, res.aji)
    assert filecmp.cmp(
        out, f"{goldens}/qsub_test_output_matrix_wheader.csv", shallow=False
    )


def test_pair_extents_golden(master_db, goldens):
    """Per-pair inclusive [start, end] extents in sorted E match the
    xanthodb_gpe_starts/ends goldens (findEBlockExtents,
    algorithm_impl.hpp:123-219)."""
    db = SCPDatabase(master_db)
    _, _, _, e = derive_single(db)
    g = len(db.meta.genome_set)
    db.close()

    def slot(a, b):  # reference ds_impl.hpp:83-86
        a = a.astype(np.int64)
        b = b.astype(np.int64)
        return g * a + b - (a + 2) * (a + 1) // 2

    starts, ends = derive_pair_extents(e, g * (g - 1) // 2, slot)
    np.testing.assert_array_equal(
        starts, golden_io.read_i32_vector(f"{goldens}/xanthodb_gpe_starts.bin")
    )
    np.testing.assert_array_equal(
        ends, golden_io.read_i32_vector(f"{goldens}/xanthodb_gpe_ends.bin")
    )


def test_thread_slab_golden(goldens):
    """The recorded 8-thread E-slab layout (constructE's weighted tetramer
    partition, ds_helper.hpp:167-201 + 362-421) — derivable from the F/Lc
    goldens alone."""
    lc = golden_io.read_i32_vector(f"{goldens}/xanthodb_lc_array.bin")
    f = golden_io.read_pair_vector(f"{goldens}/xanthodb_f_array.bin")
    starts, sizes = derive_thread_slabs(lc, f, n_threads=8)
    np.testing.assert_array_equal(
        starts, golden_io.read_i32_vector(f"{goldens}/xanthodb_e_starts.bin")
    )
    np.testing.assert_array_equal(
        sizes, golden_io.read_i32_vector(f"{goldens}/xanthodb_e_size.bin")
    )


def test_subset1_rederived_from_master(master_db, subset1_db, tmp_path):
    """Running our subset tool on the rebuilt master reproduces the bundled
    xdb_subset1.db's engine-visible content (the derivation the reference's
    data/subset_db.py performed on the real master)."""
    sub_names = [
        "Xanthomonas_albilineans_GCA_000962915_1.fna.gz",
        "Xanthomonas_albilineans_GCA_000962945_1.fna.gz",
        "Xanthomonas_albilineans_GCA_000963065_1.fna.gz",
        "Xanthomonas_albilineans_GCA_000963195_1.fna.gz",
    ]  # reference data/README.md
    out = str(tmp_path / "sub1.db")
    build_subset_db(master_db, out, sub_names)

    ours = sqlite3.connect(f"file:{out}?mode=ro", uri=True)
    theirs = sqlite3.connect(f"file:{subset1_db}?mode=ro", uri=True)
    try:
        prots = [
            r[0] for r in theirs.execute("SELECT DISTINCT SCP_acc FROM scp_data")
        ]
        assert prots == [
            r[0] for r in ours.execute("SELECT DISTINCT SCP_acc FROM scp_data")
        ]
        assert list(theirs.execute("SELECT genome_name, genome_id FROM genome_metadata")) == list(
            ours.execute("SELECT genome_name, genome_id FROM genome_metadata")
        )
        for prot in prots:
            for table, key in ((f"{prot}_tetras", "tetramer"), (f"{prot}_genomes", "genome_id")):
                a = list(ours.execute(f"SELECT * FROM '{table}' ORDER BY {key}"))
                b = list(theirs.execute(f"SELECT * FROM '{table}' ORDER BY {key}"))
                assert a == b, f"mismatch in {table}"
    finally:
        ours.close()
        theirs.close()
