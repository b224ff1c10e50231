"""Streaming large-G engine (engine.compute_streamed) vs the exact engine."""

import csv

import numpy as np

from parfastaai_jax.engine import compute, compute_streamed
from parfastaai_jax.etl.database import SCPDatabase
from parfastaai_jax.io.csv_writer import aji_matrix
from parfastaai_jax.modes import all_vs_all


def _read_csv(path, sep=","):
    with open(path) as fp:
        rows = list(csv.reader(fp, delimiter=sep))
    header = rows[0]
    assert header[0] == ""
    names = header[1:]
    row_names = [r[0] for r in rows[1:]]
    vals = np.array([[float(v) for v in r[1:]] for r in rows[1:]])
    return names, row_names, vals


def test_streamed_resume_produces_identical_file(combo12_db, tmp_path):
    """Interrupting after N complete rows and resuming must yield a file
    byte-identical to the uninterrupted run."""
    db = SCPDatabase(combo12_db)
    pres = db.load_presence()
    db.close()
    g = len(db.meta.genome_set)
    ids = np.arange(g, dtype=np.int32)
    names = db.meta.genome_set

    full = tmp_path / "full.csv"
    compute_streamed(pres, ids, ids, str(full), names, names, band=2, col_chunk=4)
    want = full.read_bytes()

    part = tmp_path / "part.csv"
    # Simulate an interrupted run: header + 4 complete rows + a torn write.
    lines = want.split(b"\n")
    part.write_bytes(b"\n".join(lines[:5]) + b"\n" + lines[5][:13])
    compute_streamed(
        pres, ids, ids, str(part), names, names, band=2, col_chunk=4, resume=True
    )
    assert part.read_bytes() == want

    # Resume with a mismatched header must rewrite from scratch.
    bad = tmp_path / "bad.csv"
    bad.write_bytes(b",wrong,header\n" + b"\n".join(lines[1:5]) + b"\n")
    compute_streamed(
        pres, ids, ids, str(bad), names, names, band=2, col_chunk=4, resume=True
    )
    assert bad.read_bytes() == want


def test_streamed_matches_exact_all_vs_all(subset1_db, tmp_path):
    db = SCPDatabase(subset1_db)
    pres = db.load_presence()
    db.close()
    pairs = all_vs_all(db.meta)
    exact_mat = aji_matrix(pairs, compute(pres, pairs).aji)

    out = tmp_path / "streamed.csv"
    g = len(db.meta.genome_set)
    ids = np.arange(g, dtype=np.int32)
    # Tiny blocks exercise banding, chunking, and padding paths (G=4, band=3).
    compute_streamed(
        pres, ids, ids, str(out), db.meta.genome_set, db.meta.genome_set,
        band=3, col_chunk=3,
    )
    names, row_names, vals = _read_csv(str(out))
    assert tuple(names) == db.meta.genome_set
    assert tuple(row_names) == db.meta.genome_set
    np.testing.assert_array_equal(np.diag(vals), 0.0)
    np.testing.assert_allclose(vals, exact_mat, rtol=1e-6, atol=0)


def test_streamed_writer_error_propagates(subset1_db, tmp_path, monkeypatch):
    """A failure in the writer thread (e.g. disk full mid-run) must surface
    as an exception to the caller, not hang the pipeline or pass silently."""
    db = SCPDatabase(subset1_db)
    pres = db.load_presence()
    db.close()
    g = len(db.meta.genome_set)
    ids = np.arange(g, dtype=np.int32)
    names = db.meta.genome_set

    calls = {"n": 0}
    # compute_streamed does `from .io.csv_writer import format_matrix` at
    # call time, so patching the module attribute reaches the writer thread.
    from parfastaai_jax.io import csv_writer

    orig = csv_writer.format_matrix

    def boom(mat, sep):
        calls["n"] += 1
        if calls["n"] >= 2:
            raise OSError("disk full (simulated)")
        return orig(mat, sep)

    monkeypatch.setattr(csv_writer, "format_matrix", boom)
    out = tmp_path / "fail.csv"
    try:
        compute_streamed(
            pres, ids, ids, str(out), names, names, band=1, col_chunk=4
        )
    except OSError as exc:
        assert "disk full" in str(exc)
    else:
        raise AssertionError("writer failure did not propagate")


def test_streamed_device_path_matches_host(subset1_db, tmp_path, monkeypatch):
    """The jitted device block path (used above HOST_WORK_LIMIT) must agree
    with the host-fallback path."""
    db = SCPDatabase(subset1_db)
    pres = db.load_presence()
    db.close()
    g = len(db.meta.genome_set)
    ids = np.arange(g, dtype=np.int32)
    names = db.meta.genome_set

    host_csv = tmp_path / "host.csv"
    compute_streamed(pres, ids, ids, str(host_csv), names, names, band=3, col_chunk=3)
    dev_csv = tmp_path / "dev.csv"
    monkeypatch.setenv("PARFASTAAI_FORCE_DEVICE", "1")
    compute_streamed(pres, ids, ids, str(dev_csv), names, names, band=3, col_chunk=3)
    _, _, host_vals = _read_csv(str(host_csv))
    _, _, dev_vals = _read_csv(str(dev_csv))
    np.testing.assert_allclose(dev_vals, host_vals, rtol=1e-6, atol=0)


def test_streamed_symmetric_mirror_byte_identical(
    subset1_db, tmp_path, monkeypatch
):
    """The f32 streamed path's symmetric mirror (r4: below-diagonal chunks
    skipped, filled from stored assembled bands) writes byte-identical CSVs
    to the full-square walk (PARFASTAAI_MIRROR_BYTES=1 disables it), at
    band/chunk sizes that exercise skipped, straddling, and short blocks."""
    import numpy as np

    from parfastaai_jax.engine import compute_streamed
    from parfastaai_jax.etl.database import SCPDatabase

    monkeypatch.setenv("PARFASTAAI_FORCE_DEVICE", "1")
    db = SCPDatabase(subset1_db)
    pres = db.load_presence()
    db.close()
    g = len(db.meta.genome_set)
    ids = np.arange(g, dtype=np.int32)
    names = db.meta.genome_set
    for band, chunk in ((1, 1), (2, 1), (1, 2), (3, 2)):
        mirrored = tmp_path / f"m{band}_{chunk}.csv"
        compute_streamed(
            pres, ids, ids, str(mirrored), names, names,
            band=band, col_chunk=chunk,
        )
        monkeypatch.setenv("PARFASTAAI_MIRROR_BYTES", "1")
        full = tmp_path / f"f{band}_{chunk}.csv"
        compute_streamed(
            pres, ids, ids, str(full), names, names,
            band=band, col_chunk=chunk,
        )
        monkeypatch.delenv("PARFASTAAI_MIRROR_BYTES")
        assert mirrored.read_bytes() == full.read_bytes(), (band, chunk)
