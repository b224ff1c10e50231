"""Native C++/OpenMP host kernels vs their NumPy twins (bit-for-bit)."""

import numpy as np
import pytest

from parfastaai_jax.native import (
    get_lib,
    native_jaccard_finish,
    native_unpack_presence,
)

pytestmark = pytest.mark.skipif(
    get_lib() is None, reason="native library unavailable (no g++?)"
)


def _numpy_finish(counts, ta, tb):
    P, n = counts.shape
    s = np.zeros(n, dtype=np.float64)
    nacc = np.zeros(n, dtype=np.int32)
    for p in range(P):
        c = counts[p]
        mask = c > 0
        cm = c[mask].astype(np.float64)
        dm = (ta[p][mask] + tb[p][mask] - c[mask]).astype(np.float64)
        s[mask] += cm / dm
        nacc += mask
    return s, nacc


def test_jaccard_finish_bit_identical():
    rng = np.random.default_rng(0)
    P, n = 80, 1000
    counts = rng.integers(0, 400, size=(P, n)).astype(np.int32)
    counts[rng.random((P, n)) < 0.3] = 0  # some empty intersections
    ta = (counts + rng.integers(0, 200, size=(P, n))).astype(np.int32)
    tb = (counts + rng.integers(0, 200, size=(P, n))).astype(np.int32)
    s_native, n_native = native_jaccard_finish(counts, ta, tb)
    s_np, n_np = _numpy_finish(counts, ta, tb)
    # Exact f64 equality — same operation order (ascending protein per pair).
    np.testing.assert_array_equal(s_native, s_np)
    np.testing.assert_array_equal(n_native, n_np)


def test_unpack_presence_matches_numpy():
    rng = np.random.default_rng(1)
    G, K = 37, 64
    blobs = [
        np.sort(rng.choice(G, size=rng.integers(0, G), replace=False)).astype(
            np.int32
        )
        for _ in range(K)
    ]
    offsets = np.zeros(K + 1, dtype=np.int64)
    np.cumsum([len(b) for b in blobs], out=offsets[1:])
    gids = np.concatenate(blobs).astype(np.int32)

    want = np.zeros((G, K), dtype=np.uint8)
    for j, b in enumerate(blobs):
        want[b, j] = 1

    got = np.zeros((G, K), dtype=np.uint8)
    assert native_unpack_presence(gids, offsets, got)
    np.testing.assert_array_equal(got, want)


def test_format_row_byte_identical_to_python():
    from parfastaai_jax.io.fmtfloat import format_double
    from parfastaai_jax.native import native_format_row

    rng = np.random.default_rng(42)
    vals = np.concatenate(
        [
            rng.random(500),
            rng.random(100) * 10.0 ** rng.integers(-20, 20, 100),
            -rng.random(100),
            np.array([0.0, -0.0, 1.0, 0.25, 1e-4, 1.0000000000000002e-4,
                      9.999999999999999e-5, 123456789.123456, 1e16 - 2.0,
                      1e16, np.nan, np.inf, -np.inf, 5e-324]),
        ]
    )
    got = native_format_row(vals, ";")
    assert got is not None, "native formatter failed its self-test"
    want = ";".join(format_double(v) for v in vals).encode()
    assert got == want


@pytest.mark.parametrize("which", ["subset1", "subset2"])
def test_native_etl_matches_python(which, subset1_db, subset2_db):
    """The fused C++ SQLite ETL (pfaai_sqlite.cpp) must produce exactly the
    tensors the stdlib-sqlite3 path builds — m, t, widths, tetramer_ids all
    array-equal (same queries through the same C library)."""
    import os

    import parfastaai_jax.native as nat
    from parfastaai_jax.etl.database import SCPDatabase
    from parfastaai_jax.native import native_load_presence

    path = {"subset1": subset1_db, "subset2": subset2_db}[which]
    db = SCPDatabase(path)
    res = native_load_presence(
        path, db.meta.protein_set, len(db.meta.genome_set)
    )
    assert res is not None, "native ETL unavailable (libsqlite3 missing?)"
    m, t, widths, tids = res

    os.environ["PARFASTAAI_NO_NATIVE"] = "1"
    nat._TRIED, nat._LIB = False, None
    try:
        pres = db.load_presence()
    finally:
        del os.environ["PARFASTAAI_NO_NATIVE"]
        nat._TRIED, nat._LIB = False, None
    db.close()
    np.testing.assert_array_equal(m, pres.m)
    np.testing.assert_array_equal(t, pres.t)
    np.testing.assert_array_equal(widths, pres.widths)
    assert len(tids) == len(pres.tetramer_ids)
    for a, b in zip(tids, pres.tetramer_ids):
        np.testing.assert_array_equal(a, b)


def test_native_etl_rejects_corrupt_db(subset1_db, tmp_path):
    """A genome id outside [0, G) must surface as PFAAIError, not memory
    corruption: the native loader returns an error, the Python fallback
    raises the taxonomy error (same behavior as without the native lib)."""
    import shutil
    import sqlite3 as sq

    from parfastaai_jax.etl.database import SCPDatabase
    from parfastaai_jax.types import PFAAIError

    bad = tmp_path / "corrupt.db"
    shutil.copy(subset1_db, bad)
    conn = sq.connect(bad)
    prot = conn.execute("SELECT DISTINCT SCP_acc FROM scp_data").fetchone()[0]
    tet = conn.execute(
        f"SELECT tetramer FROM '{prot}_tetras' LIMIT 1"
    ).fetchone()[0]
    conn.execute(
        f"UPDATE '{prot}_tetras' SET genomes = ? WHERE tetramer = ?",
        (np.asarray([999999], dtype="<i4").tobytes(), tet),
    )
    conn.commit()
    conn.close()
    db = SCPDatabase(str(bad))
    with pytest.raises(PFAAIError):
        db.load_presence()
    db.close()


def test_engine_uses_native_and_stays_bit_exact(subset1_db):
    """End-to-end: with the native finish active, AJI must still equal the
    plain f64 oracle (tests/oracle.py) bit-for-bit."""
    from oracle import aji_matrix

    from parfastaai_jax.engine import compute
    from parfastaai_jax.etl.database import SCPDatabase
    from parfastaai_jax.modes import all_vs_all

    db = SCPDatabase(subset1_db)
    pres = db.load_presence()
    db.close()
    pairs = all_vs_all(db.meta)
    result = compute(pres, pairs)
    want = aji_matrix(subset1_db)[pairs.db_a, pairs.db_b]
    np.testing.assert_array_equal(result.aji, want)
