"""CLI end-to-end: mode dispatch, output files, error paths
(mirrors the reference smoke script tests/run_tests.sh)."""

import numpy as np

from parfastaai_jax.cli import run
from parfastaai_jax.etl.goldens import read_f64_vector, read_triple_vector


def test_all_vs_all_cli(subset1_db, subset1_csv, tmp_path):
    out = tmp_path / "out.csv"
    rc = run([subset1_db, str(out), "--quiet"])
    assert rc == 0
    assert out.read_bytes() == subset1_csv


def test_qt_cli(subset1_db, subset2_db, goldens, tmp_path):
    out = tmp_path / "qt.csv"
    rc = run([subset1_db, str(out), "-r", subset2_db, "--quiet"])
    assert rc == 0
    # 4 query rows x 4 target cols; values match the QT AJI golden.
    lines = out.read_text().splitlines()
    assert len(lines) == 5
    aji = read_f64_vector(f"{goldens}/xdb_qt_aji.bin")
    got = np.array(
        [float(v) for line in lines[1:] for v in line.split(",")[1:]]
    )
    np.testing.assert_array_equal(got, aji)


def test_qsub_cli(tmp_path, combo12_db):
    from parfastaai_jax.etl.database import SCPDatabase

    db = SCPDatabase(combo12_db)
    names = db.meta.genome_set[:3]
    db.close()
    qfile = tmp_path / "q.txt"
    qfile.write_text("\n".join(names) + "\n")
    out = tmp_path / "qs.csv"
    rc = run([combo12_db, str(out), "-q", str(qfile), "--quiet"])
    assert rc == 0
    lines = out.read_text().splitlines()
    assert len(lines) == 1 + 3  # header + one row per query genome
    assert lines[1].split(",")[0] == names[0]


def test_bad_query_list_cli(tmp_path, combo12_db, capsys):
    qfile = tmp_path / "bad.txt"
    qfile.write_text("definitely_not_a_genome\n")
    out = tmp_path / "x.csv"
    rc = run([combo12_db, str(out), "-q", str(qfile), "--quiet"])
    assert rc != 0
    assert not out.exists()


def test_dump_jac_flag(subset1_db, goldens, tmp_path):
    """--dump-jac writes the per-pair JAC tuples matching the golden JAC
    archive (S within the reference's own 1e-7 JACTuple tolerance; here the
    engine is bit-exact so the strings round-trip exactly)."""
    import numpy as np

    from parfastaai_jax.cli import run
    from parfastaai_jax.etl.goldens import read_jac_vector

    out = tmp_path / "aji.csv"
    jac = tmp_path / "jac.csv"
    assert run([subset1_db, str(out), "--quiet", "--dump-jac", str(jac)]) == 0
    golden = read_jac_vector(f"{goldens}/xdb_subset1_jac.bin")
    lines = jac.read_text().splitlines()
    assert lines[0] == "genomeA,genomeB,S,N,AJI"
    assert len(lines) - 1 == len(golden)
    for line, g in zip(lines[1:], golden):
        ga, gb, s, n, _ = line.split(",")
        assert (int(ga), int(gb), int(n)) == (g["genome_a"], g["genome_b"], g["n"])
        assert float(s) == g["s"]


def test_separator_flag(subset1_db, tmp_path):
    out = tmp_path / "tab.csv"
    rc = run([subset1_db, str(out), "-s", "\t", "--quiet"])
    assert rc == 0
    assert "\t" in out.read_text().splitlines()[0]


def test_dump_e_flag(subset1_db, goldens, tmp_path):
    """--dump-e writes the sorted E array equal to the golden archive
    (reference print_e, algorithm_impl.hpp:331-343)."""
    out = tmp_path / "aji.csv"
    e_csv = tmp_path / "e.csv"
    assert run([subset1_db, str(out), "--quiet", "--dump-e", str(e_csv)]) == 0
    lines = e_csv.read_text().splitlines()
    assert lines[0] == "proteinIndex,genomeA,genomeB"
    e = np.array([[int(x) for x in ln.split(",")] for ln in lines[1:]])
    golden = read_triple_vector(f"{goldens}/xdb_subset1_sorted_e_array.bin")
    np.testing.assert_array_equal(e, golden)


def test_dump_e_qsub_mode(tmp_path, combo12_db):
    """--dump-e in query-subset mode: the qsub E must be
    exactly the all-vs-all E rows whose pairs satisfy the qsub isValidPair
    (both-query a<b, or query x target; ds_impl.hpp:270-273)."""
    from parfastaai_jax.etl.database import SCPDatabase

    db = SCPDatabase(combo12_db)
    names = db.meta.genome_set
    db.close()
    queries = tmp_path / "q.txt"
    qnames = [names[0], names[3]]
    queries.write_text("\n".join(qnames) + "\n")

    e_q = tmp_path / "e_qsub.csv"
    assert run(
        [combo12_db, str(tmp_path / "o1.csv"), "-q", str(queries), "--quiet",
         "--dump-e", str(e_q)]
    ) == 0
    e_all = tmp_path / "e_all.csv"
    assert run(
        [combo12_db, str(tmp_path / "o2.csv"), "--quiet",
         "--dump-e", str(e_all)]
    ) == 0

    def load(p):
        lines = p.read_text().splitlines()[1:]
        return np.array([[int(x) for x in ln.split(",")] for ln in lines])

    eq, ea = load(e_q), load(e_all)
    is_q = np.zeros(len(names), dtype=bool)
    is_q[[names.index(q) for q in qnames]] = True
    a, b = ea[:, 1], ea[:, 2]
    keep = (is_q[a] & is_q[b]) | (is_q[a] & ~is_q[b])
    # All-vs-all E only holds a<b rows; qsub additionally emits (query a,
    # target b) with a > b, which the a<b rows mirror.
    mirror = ~is_q[a] & is_q[b]
    em = ea[mirror][:, [0, 2, 1]]
    want = np.concatenate([ea[keep], em])
    order = np.lexsort((want[:, 0], want[:, 2], want[:, 1]))
    np.testing.assert_array_equal(eq, want[order])


def test_streamed_exact_cli_byte_identical_to_golden(
    subset1_db, subset1_csv, tmp_path
):
    """--streamed --exact must reproduce the golden CSV byte for byte (it IS
    the exact engine, banded)."""
    out = tmp_path / "exact_banded.csv"
    rc = run(
        [subset1_db, str(out), "--quiet", "--streamed",
         "--exact", "--band", "2", "--col-chunk", "3"]
    )
    assert rc == 0
    assert out.read_bytes() == subset1_csv


def test_exact_flag_validation(subset1_db, tmp_path, capsys):
    """--exact requires --streamed; --mesh composes with it (mesh-parallel
    count production, same bytes)."""
    out = str(tmp_path / "o.csv")
    assert run([subset1_db, out, "--quiet", "--exact"]) != 0
    capsys.readouterr()


def test_exact_mesh_cli(subset1_db, subset1_csv, tmp_path, capsys):
    """--streamed --exact --mesh 2,2 writes the golden CSV byte-for-byte
    (exactness composes with multi-device)."""
    out = tmp_path / "o.csv"
    rc = run([subset1_db, str(out), "--quiet", "--streamed", "--exact",
              "--mesh", "2,2", "--band", "2", "--col-chunk", "3"])
    assert rc == 0
    assert out.read_bytes() == subset1_csv
    capsys.readouterr()


def test_python_m_module_entry(subset1_db, subset1_csv, tmp_path):
    """``python -m parfastaai_jax`` (package __main__) is the console-script
    surface for uninstalled checkouts — byte-identical output and the same
    exit codes as the in-process run()."""
    import os
    import subprocess
    import sys

    out = tmp_path / "m.csv"
    env = dict(os.environ)
    # Keep the subprocess host-side and hermetic: the fixture DB is tiny and
    # the MAC threshold routes it to numpy without touching a backend.
    env["PARFASTAAI_HOST_WORK_LIMIT"] = "1e18"
    env.pop("PARFASTAAI_FORCE_DEVICE", None)
    cp = subprocess.run(
        [sys.executable, "-m", "parfastaai_jax", subset1_db, str(out),
         "--quiet"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert cp.returncode == 0, cp.stderr
    assert out.read_bytes() == subset1_csv
    # Error path: missing database -> the reference's DB error code (1).
    cp = subprocess.run(
        [sys.executable, "-m", "parfastaai_jax", "/nonexistent.db",
         str(tmp_path / "e.csv"), "--quiet"],
        env=env, capture_output=True, text=True, timeout=120,
    )
    assert cp.returncode == 1


def test_exact_auto_routes_to_banded_over_budget(
    subset1_db, subset1_csv, tmp_path, monkeypatch
):
    """When the dense exact path's host footprint exceeds
    PARFASTAAI_EXACT_HOST_BYTES, the default path auto-routes through the
    banded exact engine and still writes the identical golden bytes."""
    out = tmp_path / "auto.csv"
    monkeypatch.setenv("PARFASTAAI_EXACT_HOST_BYTES", "1")
    rc = run([subset1_db, str(out), "--quiet"])
    assert rc == 0
    assert out.read_bytes() == subset1_csv


def test_exact_auto_route_pinned_dense_by_dump_jac(
    subset1_db, subset1_csv, tmp_path, monkeypatch
):
    """--dump-jac needs the per-pair JacResult, so it pins the dense exact
    path even over budget — and still succeeds at parity scale."""
    out = tmp_path / "pin.csv"
    jac = tmp_path / "pin_jac.csv"
    monkeypatch.setenv("PARFASTAAI_EXACT_HOST_BYTES", "1")
    rc = run([subset1_db, str(out), "--quiet", "--dump-jac", str(jac)])
    assert rc == 0
    assert jac.exists()
    assert out.read_bytes() == subset1_csv


def test_exact_auto_routes_qt_mode(
    subset1_db, subset2_db, tmp_path, monkeypatch
):
    """Two-database auto-routing keeps the compat T-swap (banded engine
    receives the swapped denominator columns through StreamAxes): the
    routed CSV equals the dense exact path's byte for byte."""
    dense = tmp_path / "qt_dense.csv"
    assert run([subset1_db, str(dense), "-r", subset2_db, "--quiet"]) == 0
    out = tmp_path / "qt_auto.csv"
    monkeypatch.setenv("PARFASTAAI_EXACT_HOST_BYTES", "1")
    rc = run([subset1_db, str(out), "-r", subset2_db, "--quiet"])
    assert rc == 0
    assert out.read_bytes() == dense.read_bytes()


def test_mesh_spec_validation(subset1_db, tmp_path, capsys):
    """A malformed --mesh is rejected on every process BEFORE any collective
    (exit 3, no CSV): in a multi-process run, a spec that only the primary
    parses would otherwise kill the primary while the non-primaries sit in
    the presence broadcast."""
    db = subset1_db
    out = tmp_path / "o.csv"
    # ("" is falsy and coherently means "no mesh" at every args.mesh site.)
    for bad in ("bogus", "2,x", "0,1", "-2", "1,2,3"):
        rc = run([db, str(out), "--quiet", "--streamed", "--mesh", bad])
        assert rc == 3, bad
        assert not out.exists(), bad
    err = capsys.readouterr().err
    assert "--mesh expects" in err
