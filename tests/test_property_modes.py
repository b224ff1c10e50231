"""Property tests for MODE semantics: random databases
fuzzed through the qsub / QT pair spaces against brute-force oracles derived
INDEPENDENTLY from the reference's definitions (not from this repo's axis
vectors), plus resume with adversarial truncation points.

Oracle sources:
* qsub CSV scatter: reference printOutput src/main.cpp:133-175 (mirrored
  query-query cells, untouched cells print 0) over ParFAAIQSubData's pair
  validity (ds_impl.hpp:267-276: both-query a<b, or query x non-query).
* QT denominator quirk: computeEBlockJAC indexes T with JAC labels
  (algorithm_impl.hpp:250-253) while T's columns are DB ids — for pair
  (query qIdx, target tIdx) the denominator reads T[p, qIdx] + T[p, nq+tIdx]
  (ds_impl.hpp:428-439); the no-compat formula reads the genuine columns.
"""

import numpy as np
import pytest

from parfastaai_jax.engine import compute, compute_streamed_exact
from parfastaai_jax.etl.database import PresenceData
from parfastaai_jax.io.csv_writer import write_aji_csv
from parfastaai_jax.modes import (
    all_vs_all_axes,
    query_subset,
    query_target,
)
from parfastaai_jax.types import DBMetaData, PFAAIError


def _random_presence(P, G, K, seed, query_names=()):
    rng = np.random.default_rng(seed)
    m = (rng.random((P, G, K)) < rng.uniform(0.05, 0.6)).astype(np.uint8)
    absent = rng.random((P, G)) < 0.2  # some proteins missing entirely
    m[absent] = 0
    t = m.sum(axis=2, dtype=np.int32)
    nq = len(query_names)
    meta = DBMetaData(
        protein_set=tuple(f"P{i}" for i in range(P)),
        genome_set=tuple(f"g{i:02d}" for i in range(G - nq)),
        query_genome_set=tuple(query_names),
    )
    return PresenceData(
        meta=meta,
        m=m,
        t=t,
        widths=np.full(P, K, np.int32),
        tetramer_ids=[np.arange(K, dtype=np.int32)] * P,
    )


def _aji_oracle(m, a, b, ta=None, tb=None):
    """Set-based AJI for one pair with EXPLICIT denominator T columns
    (defaults to the genuine |A|/|B| set sizes)."""
    P = m.shape[0]
    s, n = 0.0, 0
    for p in range(P):
        sa = set(np.flatnonzero(m[p, a]).tolist())
        sb = set(np.flatnonzero(m[p, b]).tolist())
        inter = len(sa & sb)
        if inter > 0:
            da = len(sa) if ta is None else int(ta[p])
            db = len(sb) if tb is None else int(tb[p])
            s += inter / (da + db - inter)
            n += 1
    return (s / n if n else float("nan")), n


def _read_csv_matrix(path, ncols):
    return np.atleast_2d(
        np.genfromtxt(
            path, delimiter=",", skip_header=1, usecols=range(1, ncols + 1)
        )
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_qsub_csv_matches_bruteforce(seed, tmp_path):
    """Random DB + random query subset (random order): the full qsub CSV
    matrix equals a cell-by-cell brute-force reconstruction of the
    reference's scatter (mirrored query-query cells, 0 elsewhere)."""
    rng = np.random.default_rng(100 + seed)
    P, G, K = 5, rng.integers(5, 10), 96
    pres = _random_presence(P, G, K, seed)
    names = pres.meta.genome_set
    nq = int(rng.integers(2, G - 1))
    q_idx = rng.choice(G, nq, replace=False)  # random order, non-contiguous
    queries = [names[i] for i in q_idx]

    pairs = query_subset(pres.meta, queries)
    out = tmp_path / f"qs{seed}.csv"
    write_aji_csv(str(out), pairs, compute(pres, pairs).aji)
    got = _read_csv_matrix(out, G)

    is_query = np.zeros(G, bool)
    is_query[q_idx] = True
    want = np.zeros((nq, G))
    for qi, a in enumerate(q_idx):
        for gj in range(G):
            if gj == a:
                continue  # untouched diagonal cell -> 0
            if is_query[gj]:
                # both-query pairs are computed once (a < b) and mirrored
                # to both cells (main.cpp:150-153) — value is symmetric.
                want[qi, gj] = _aji_oracle(pres.m, min(a, gj), max(a, gj))[0]
            else:
                want[qi, gj] = _aji_oracle(pres.m, a, gj)[0]
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(
        np.nan_to_num(got), np.nan_to_num(want), rtol=0, atol=0
    )


@pytest.mark.parametrize("seed", [3, 4])
def test_qsub_bad_query_lists_rejected(seed, tmp_path):
    """Unknown and duplicate query names raise (reference validate_subset
    src/main.cpp:204-232 for unknown; duplicate rejection is the documented
    PARITY.md divergence) — at ANY position in the list."""
    rng = np.random.default_rng(seed)
    pres = _random_presence(4, 6, 64, seed)
    names = list(pres.meta.genome_set)
    base = [names[i] for i in rng.choice(6, 3, replace=False)]
    for bad in (base[: rng.integers(0, 3)] + ["NOPE"] + base,
                base + [base[rng.integers(0, 3)]]):
        with pytest.raises(PFAAIError):
            query_subset(pres.meta, bad)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("compat", [True, False])
def test_qt_csv_matches_bruteforce(seed, compat, tmp_path):
    """Random two-database layout (nq <= nt, the reference-defined regime):
    the QT CSV equals a brute-force oracle whose denominators implement the
    T-swap quirk directly from the reference's JAC-label arithmetic."""
    rng = np.random.default_rng(200 + seed)
    nt = int(rng.integers(3, 7))
    nq = int(rng.integers(2, nt + 1))
    P, K = 5, 96
    pres = _random_presence(
        P, nt + nq, K, seed, query_names=[f"q{i:02d}" for i in range(nq)]
    )
    pairs = query_target(pres.meta, compat_qt_t_swap=compat)
    out = tmp_path / f"qt{seed}{compat}.csv"
    write_aji_csv(str(out), pairs, compute(pres, pairs).aji)
    got = _read_csv_matrix(out, nt)

    t = pres.t
    want = np.zeros((nq, nt))
    for qi in range(nq):
        for tj in range(nt):
            a, b = nt + qi, tj  # presence columns: targets first, then queries
            if compat:
                # Quirk: T indexed with JAC labels (query qi -> label qi,
                # target tj -> label nq + tj) against DB-id columns.
                da, db = t[:, qi], t[:, nq + tj]
            else:
                da, db = t[:, a], t[:, b]
            want[qi, tj] = _aji_oracle(pres.m, a, b, ta=da, tb=db)[0]
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(
        np.nan_to_num(got), np.nan_to_num(want), rtol=0, atol=0
    )


def test_qt_compat_changes_values_when_t_differs(tmp_path):
    """Sanity that the fuzz actually distinguishes the two formulas: with
    asymmetric T columns, compat on/off must differ somewhere (else the
    oracle above would pass vacuously)."""
    pres = _random_presence(5, 9, 96, 42, query_names=[f"q{i}" for i in range(4)])
    a = compute(pres, query_target(pres.meta, compat_qt_t_swap=True)).aji
    b = compute(pres, query_target(pres.meta, compat_qt_t_swap=False)).aji
    mask = ~(np.isnan(a) & np.isnan(b))
    assert not np.array_equal(a[mask], b[mask])


def test_qt_overlapping_genomes_rejected():
    """Overlapping query/target genome sets raise and the message names the
    overlap (reference validate_qry2tgt src/main.cpp:268-300)."""
    pres = _random_presence(3, 6, 64, 7, query_names=["g01", "qx"])
    with pytest.raises(PFAAIError, match="g01"):
        query_target(pres.meta)


@pytest.mark.parametrize("seed", [0, 1])
def test_exact_resume_truncation_fuzz(seed, tmp_path):
    """Banded exact resume under adversarial truncation: cut the CSV at
    random byte offsets (inside the header, mid-line, mid-band, at band
    boundaries, last byte) — every resume must finish byte-identical to the
    clean run (the CSV is the checkpoint; torn tails are discarded)."""
    pres = _random_presence(4, 7, 64, 300 + seed)
    axes = all_vs_all_axes(pres.meta)
    names = pres.meta.genome_set

    def run(path, resume=False):
        compute_streamed_exact(
            pres, axes.row_db_ids, axes.col_db_ids, str(path),
            names, names, band=2, col_chunk=3, resume=resume,
        )

    clean = tmp_path / "clean.csv"
    run(clean)
    full = clean.read_bytes()
    header_end = full.index(b"\n") + 1
    rng = np.random.default_rng(seed)
    band_rows = full[header_end:].split(b"\n")
    band2_end = header_end + sum(len(r) + 1 for r in band_rows[:2])
    cuts = sorted(
        {
            0,  # empty file
            header_end - 3,  # torn header
            header_end,  # header only
            band2_end,  # exact band boundary
            band2_end + 5,  # mid-line of the next band
            len(full) - 1,  # last byte missing
            *(int(x) for x in rng.integers(1, len(full), 3)),
        }
    )
    for cut in cuts:
        out = tmp_path / f"r{seed}_{cut}.csv"
        out.write_bytes(full[:cut])
        run(out, resume=True)
        assert out.read_bytes() == full, f"cut at {cut} diverged"


def test_exact_resume_wrong_header_recomputes(tmp_path):
    """A file whose header does not match (e.g. different separator or
    column set) is NOT a valid checkpoint: resume must rewrite from
    scratch and still produce the clean bytes."""
    pres = _random_presence(4, 6, 64, 9)
    axes = all_vs_all_axes(pres.meta)
    names = pres.meta.genome_set
    clean = tmp_path / "c.csv"
    compute_streamed_exact(
        pres, axes.row_db_ids, axes.col_db_ids, str(clean), names, names,
        band=2, col_chunk=3,
    )
    out = tmp_path / "wrong.csv"
    out.write_bytes(b";wrong;header\njunk,1,2\n")
    compute_streamed_exact(
        pres, axes.row_db_ids, axes.col_db_ids, str(out), names, names,
        band=2, col_chunk=3, resume=True,
    )
    assert out.read_bytes() == clean.read_bytes()
