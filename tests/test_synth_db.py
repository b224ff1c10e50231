"""Synthetic DB generator: schema consistency with the real fixtures and
self-consistency of the data it produces."""

import sqlite3

import numpy as np
import pytest

from parfastaai_jax.engine import compute
from parfastaai_jax.etl.database import SCPDatabase
from parfastaai_jax.etl.derive import derive_single
from parfastaai_jax.modes import all_vs_all
from parfastaai_jax.tools.synth_db import generate


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("synth") / "tiny.db")
    generate(path, n_genomes=6, n_proteins=4, pool_size=120,
             tetras_per_genome=40, seed=5)
    return path


def test_schema_matches_fixture(synth, subset1_db):
    def table_defs(p):
        conn = sqlite3.connect(f"file:{p}?mode=ro", uri=True)
        try:
            rows = conn.execute(
                "SELECT sql FROM sqlite_master WHERE type='table' AND "
                "name IN ('genome_metadata','scp_data','index_protein','protein_index')"
                " ORDER BY name"
            ).fetchall()
            return [r[0].replace("IF NOT EXISTS ", "") for r in rows]
        finally:
            conn.close()

    def norm(sqls):
        return [
            " ".join(s.split())
            .replace('"', "'")
            .replace("( ", "(")
            .replace(" )", ")")
            for s in sqls
        ]

    assert norm(table_defs(synth)) == norm(table_defs(subset1_db))


def test_tetras_and_genomes_tables_consistent(synth):
    """The inverted '_tetras' index must agree with the '_genomes' sets —
    the same invariant the real databases satisfy (SURVEY §7.2)."""
    db = SCPDatabase(synth)
    pres = db.load_presence()
    # T from '_genomes' must equal rowsums of the presence built from '_tetras'.
    np.testing.assert_array_equal(
        pres.t, pres.m.sum(axis=2, dtype=np.int32)
    )
    # Lc from derive (reads '_tetras') must total the same entries.
    lc, lp, f, e = derive_single(db)
    assert lc.sum() == pres.t.sum()
    db.close()


def test_engine_runs_on_synth(synth):
    db = SCPDatabase(synth)
    pres = db.load_presence()
    db.close()
    res = compute(pres, all_vs_all(db.meta))
    aji = res.aji
    assert np.isfinite(aji).all()
    assert ((aji >= 0) & (aji <= 1)).all()
