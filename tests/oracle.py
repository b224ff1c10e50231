"""Plain f64 AJI oracle, independent of the engine.

Reads each genome's tetramer set per protein straight from the SQLite
``'{SCP}_genomes'`` blobs and intersects the sets as bitsets (AND +
popcount) — no presence tensor, no Gram matmul.  Per pair (A, B), proteins
are visited in the reference's ascending protein order
(``SELECT DISTINCT SCP_acc FROM scp_data``):

    cnt = |A_p & B_p|,  T = |set|,  S += cnt / (T_A + T_B - cnt)  (cnt > 0)
    N += [cnt > 0],     AJI = S / N  (nan when N == 0)

Every step is exact integer work up to the one f64 divide and add per
protein, in the same order as the engine's exact path, so the two agree
bit for bit.
"""

from __future__ import annotations

import sqlite3

import numpy as np


def _tetramer_sets(db_path: str):
    """(genome names, [per protein: {genome name: sorted int32 tetramers}])
    in the database's genome and protein order."""
    conn = sqlite3.connect(f"file:{db_path}?mode=ro", uri=True)
    try:
        id_name = conn.execute(
            "SELECT genome_name, genome_id FROM genome_metadata"
        ).fetchall()
        names = [n for n, _ in id_name]
        by_id = {gid: n for n, gid in id_name}
        prots = [
            r[0] for r in conn.execute("SELECT DISTINCT SCP_acc FROM scp_data")
        ]
        sets = []
        for prot in prots:
            rows = conn.execute(
                f"SELECT genome_id, tetramers FROM '{prot}_genomes'"
            ).fetchall()
            sets.append(
                {by_id[g]: np.frombuffer(b, dtype="<i4") for g, b in rows}
            )
    finally:
        conn.close()
    return names, sets


def _bitsets(sets_p: dict, names: list[str]):
    """Per-genome bitsets (uint64 words) over one protein's tetramer
    union, plus the genome-has-protein mask.  A genome without the protein
    is empty."""
    union = np.unique(np.concatenate(list(sets_p.values())))
    bits = np.zeros((len(names), len(union)), dtype=bool)
    has = np.zeros(len(names), dtype=bool)
    for i, name in enumerate(names):
        tets = sets_p.get(name)
        if tets is not None:
            bits[i, np.searchsorted(union, tets)] = True
            has[i] = True
    packed = np.packbits(bits, axis=1)
    packed = np.pad(packed, ((0, 0), (0, -packed.shape[1] % 8)))
    return np.ascontiguousarray(packed).view(np.uint64), has


def aji_matrix(
    db_path: str,
    row_names: list[str] | None = None,
    col_names: list[str] | None = None,
) -> np.ndarray:
    """(len(rows), len(cols)) f64 AJI for genome names of one database
    (default: every genome, all-vs-all).  Same-genome cells are the
    genome's self-AJI (1.0); the CSV writes those as 0."""
    names, sets = _tetramer_sets(db_path)
    idx = {n: i for i, n in enumerate(names)}
    rows = [idx[n] for n in (row_names or names)]
    cols = [idx[n] for n in (col_names or names)]
    s = np.zeros((len(rows), len(cols)), dtype=np.float64)
    n = np.zeros((len(rows), len(cols)), dtype=np.int64)
    for sets_p in sets:
        packed, has = _bitsets(sets_p, names)
        pa, pb = packed[rows], packed[cols]
        t = np.bitwise_count(packed).sum(axis=1, dtype=np.int64)
        cnt = np.zeros((len(rows), len(cols)), dtype=np.int64)
        for w in range(packed.shape[1]):
            cnt += np.bitwise_count(pa[:, w, None] & pb[None, :, w])
        shared = (cnt > 0) & has[rows][:, None] & has[cols][None, :]
        denom = t[rows][:, None] + t[cols][None, :] - cnt
        s[shared] += cnt[shared] / denom[shared]
        n += shared
    with np.errstate(divide="ignore", invalid="ignore"):
        return s / n


def aji_csv(db_path: str, separator: str = ",") -> bytes:
    """The all-vs-all CSV the reference writes for ``db_path``: header of
    genome names, one row per genome, same-genome cells 0, no-shared-protein
    cells nan, shortest-round-trip doubles."""
    from parfastaai_jax.io.fmtfloat import format_double

    names, _ = _tetramer_sets(db_path)
    mat = aji_matrix(db_path)
    np.fill_diagonal(mat, 0.0)
    lines = [separator + separator.join(names)]
    for name, row in zip(names, mat):
        lines.append(name + separator + separator.join(map(format_double, row)))
    return ("\n".join(lines) + "\n").encode()
