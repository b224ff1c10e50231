"""Rebuild a FastAAI SQLite database from the reference's golden archives.

The reference checkout strips its 20-genome master database
(``modified_xantho_fastaai2.db`` is listed in
/root/reference/.MISSING_LARGE_BLOBS), but the golden arrays derived from it
survive — and the F array *is* the complete inverted index:

* ``xanthodb_f_array.bin`` — every (proteinIndex, genomeId) occurrence,
  grouped by tetramer (reference scp_db.hpp:161-216: the ``{SCP}_tetras``
  blobs streamed in ORDER BY tetramer, protein-index order), |F| = 310,451.
* ``xanthodb_lc_array.bin`` — per-tetramer occurrence counts
  (ds_helper.hpp:82-109), which delimit the tetramer blocks of F.

From those two arrays this tool reconstructs a database with byte-identical
``{SCP}_tetras`` blobs (genome-id order preserved from F), the implied
``{SCP}_genomes`` tables (ascending-tetramer blobs; the reference only ever
reads their lengths — scp_db.hpp:253-256 — and set content), and metadata
tables whose SQLite emission orders reproduce the reference's protein/genome
index spaces (db_helper.hpp:86,195).  Optional donor databases (the bundled
subset DBs, which were derived *from* the master with ids remapped but blobs
and scores unchanged — data/subset_db.py:162-170) contribute true
``genome_length``/``genome_class``/``SCP_score`` values where available;
fields no reader consumes default to 0.

The result is not bit-identical to the lost file (SQLite pages, row order of
unread columns), but is *semantically* identical: every query the engine or
the reference issues returns the same rows, verified in
tests/test_master_rebuild.py by round-tripping Lc/Lp/F/T and reproducing the
xanthodb AJI/JAC/CSV and query-subset goldens bit-for-bit.
"""

from __future__ import annotations

import argparse
import os
import sqlite3

import numpy as np

from ..constants import NTETRAMERS
from ..etl import goldens


def genome_names_from_csv_header(csv_path: str, separator: str = ",") -> list[str]:
    """Genome names in id order, from a golden AJI CSV's header row
    (reference printOutput, src/main.cpp:144-148: sep + target names)."""
    with open(csv_path) as fp:
        header = fp.readline().rstrip("\n")
    cells = header.split(separator)
    assert cells[0] == "", "header must start with the separator"
    return cells[1:]


def protein_names_from_db(db_path: str) -> list[str]:
    """A database's protein set in SQLite DISTINCT emission order (the same
    query the engine and the reference use, db_helper.hpp:195)."""
    conn = sqlite3.connect(f"file:{db_path}?mode=ro", uri=True)
    try:
        return [
            r[0] for r in conn.execute("SELECT DISTINCT SCP_acc FROM scp_data")
        ]
    finally:
        conn.close()


def _donor_metadata(donor_dbs: list[str]):
    """True genome_length/genome_class/SCP_score values from derived DBs
    (blobs and scores are copied unchanged by the subset tool, so these are
    the master's own values for the genomes they cover)."""
    glen: dict[str, int] = {}
    gcls: dict[str, int] = {}
    score: dict[tuple[str, str], float] = {}
    for path in donor_dbs:
        conn = sqlite3.connect(f"file:{path}?mode=ro", uri=True)
        try:
            id_to_name = {}
            for name, gid, length, cls, _ in conn.execute(
                "SELECT genome_name, genome_id, genome_length, genome_class,"
                " SCP_count FROM genome_metadata"
            ):
                id_to_name[gid] = name
                glen.setdefault(name, length)
                gcls.setdefault(name, cls)
            for gid, acc, sc in conn.execute(
                "SELECT genome_id, SCP_acc, SCP_score FROM scp_data"
            ):
                score.setdefault((id_to_name[gid], acc), sc)
        finally:
            conn.close()
    return glen, gcls, score


def rebuild_master_db(
    dst_path: str,
    f_array_path: str,
    lc_array_path: str,
    genome_names: list[str],
    protein_names: list[str],
    donor_dbs: list[str] | None = None,
) -> None:
    """Write ``dst_path`` as the database implied by the F/Lc golden arrays.

    ``genome_names[i]`` names genome id i; ``protein_names[p]`` names the
    protein with F index p, in the master's DISTINCT emission order.
    """
    if os.path.exists(dst_path):
        raise FileExistsError(f"Refusing to overwrite existing {dst_path}")
    f = goldens.read_pair_vector(f_array_path)
    lc = goldens.read_i32_vector(lc_array_path)
    if lc.shape != (NTETRAMERS,) or int(lc.sum()) != len(f):
        raise ValueError(
            f"Inconsistent golden inputs: Lc shape {lc.shape} / sum "
            f"{int(lc.sum())} does not match |F| = {len(f)}"
        )
    n_prot = int(f[:, 0].max()) + 1
    n_gen = int(f[:, 1].max()) + 1
    if n_prot != len(protein_names):
        raise ValueError(
            f"F array uses {n_prot} proteins but {len(protein_names)} names given"
        )
    if n_gen > len(genome_names):
        raise ValueError(
            f"F array uses {n_gen} genome ids but {len(genome_names)} names given"
        )

    # Tetramer of every F row: blocks of Lc[t] rows per tetramer in id order.
    occ = np.flatnonzero(lc)
    tet_of_row = np.repeat(occ.astype(np.int32), lc[occ])
    prot = f[:, 0]
    gid = f[:, 1]

    # Run boundaries: a run is one (tetramer, protein) blob of the original
    # '{SCP}_tetras' table; genome-id order within it is preserved verbatim.
    change = np.flatnonzero(
        (np.diff(tet_of_row) != 0) | (np.diff(prot) != 0)
    )
    starts = np.concatenate(([0], change + 1))
    ends = np.concatenate((change + 1, [len(f)]))

    glen, gcls, score = _donor_metadata(donor_dbs or [])

    dst = sqlite3.connect(dst_path)
    try:
        _write(
            dst, genome_names, protein_names, tet_of_row, prot, gid,
            starts, ends, glen, gcls, score,
        )
    finally:
        dst.close()


def _write(
    dst, genome_names, protein_names, tet_of_row, prot, gid, starts, ends,
    glen, gcls, score,
):
    n_prot = len(protein_names)
    n_gen = len(genome_names)

    # T[p, g] = distinct tetramers of protein p in genome g, for SCP_count /
    # tetra_count metadata (reference scp_db.hpp:253-256 reads blob length).
    t = np.zeros((n_prot, n_gen), dtype=np.int64)
    np.add.at(t, (prot, gid), 1)

    dst.execute(
        "CREATE TABLE 'genome_metadata' (genome_name TEXT, genome_id INTEGER "
        "PRIMARY KEY, genome_length INTEGER, genome_class INTEGER, SCP_count INTEGER)"
    )
    dst.executemany(
        "INSERT INTO genome_metadata VALUES (?,?,?,?,?)",
        [
            (name, i, glen.get(name, 0), gcls.get(name, 0),
             int((t[:, i] > 0).sum()))
            for i, name in enumerate(genome_names)
        ],
    )

    # scp_data rows ordered by (protein index, genome id): first occurrences
    # then emit in protein_names order under SELECT DISTINCT SCP_acc, pinning
    # the engine's protein index space to F's.
    dst.execute(
        "CREATE TABLE 'scp_data' (genome_id INTEGER, SCP_acc TEXT, "
        "SCP_score REAL, tetra_count INTEGER)"
    )
    dst.executemany(
        "INSERT INTO scp_data VALUES (?,?,?,?)",
        [
            (g, acc, score.get((genome_names[g], acc), 0.0), int(t[p, g]))
            for p, acc in enumerate(protein_names)
            for g in range(n_gen)
            if t[p, g] > 0
        ],
    )

    # index_protein / protein_index: lowercase accession <-> 1-based number
    # (observed layout of the bundled DBs; copied verbatim by the reference's
    # subset tool, data/subset_db.py:223-260).  No engine path reads them.
    dst.execute(
        "CREATE TABLE index_protein (protein_number INTEGER PRIMARY KEY, "
        "protein_string VARCHAR(255) NOT NULL)"
    )
    dst.execute(
        "CREATE TABLE protein_index (protein_string VARCHAR(255) NOT NULL "
        "PRIMARY KEY, protein_number INTEGER)"
    )
    for i, acc in enumerate(sorted(p.lower() for p in protein_names)):
        dst.execute("INSERT INTO index_protein VALUES (?,?)", (i + 1, acc))
        dst.execute("INSERT INTO protein_index VALUES (?,?)", (acc, i + 1))

    for p, acc in enumerate(protein_names):
        dst.execute(
            f"CREATE TABLE '{acc}_tetras' "
            "(tetramer INTEGER PRIMARY KEY, genomes BLOB)"
        )
        runs = np.flatnonzero(prot[starts] == p)
        dst.executemany(
            f"INSERT INTO '{acc}_tetras' VALUES (?,?)",
            [
                (
                    int(tet_of_row[starts[r]]),
                    gid[starts[r] : ends[r]].astype("<i4").tobytes(),
                )
                for r in runs
            ],
        )
        dst.execute(
            f"CREATE INDEX `{acc}_tetras_index` ON `{acc}_tetras` (tetramer)"
        )

        # '{acc}_genomes': per genome, ascending-tetramer blob.  Rows of this
        # protein are already ascending in tetramer (F is tetramer-grouped in
        # id order), so a stable sort by genome id preserves that order.
        sel = prot == p
        g_p = gid[sel]
        tets_p = tet_of_row[sel]
        order = np.argsort(g_p, kind="stable")
        g_sorted = g_p[order]
        tets_sorted = tets_p[order]
        bounds = np.flatnonzero(np.diff(g_sorted)) + 1
        dst.execute(
            f"CREATE TABLE '{acc}_genomes' "
            "(genome_id INTEGER PRIMARY KEY, tetramers BLOB)"
        )
        dst.executemany(
            f"INSERT INTO '{acc}_genomes' VALUES (?,?)",
            [
                (int(grp[0]), tet.astype("<i4").tobytes())
                for grp, tet in zip(
                    np.split(g_sorted, bounds), np.split(tets_sorted, bounds)
                )
            ],
        )
    dst.commit()


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="parfastaai-jax-rebuild-master-db",
        description="Rebuild a FastAAI SQLite database from golden F/Lc archives",
    )
    p.add_argument("dst_db", help="Output database path (must not exist)")
    p.add_argument("--f-array", required=True, help="Golden F array (cereal bin)")
    p.add_argument("--lc-array", required=True, help="Golden Lc array (cereal bin)")
    p.add_argument(
        "--genome-names-csv",
        required=True,
        help="Golden AJI CSV whose header row carries genome names in id order",
    )
    p.add_argument(
        "--proteins-from-db",
        required=True,
        help="Donor DB supplying protein names in DISTINCT order",
    )
    p.add_argument(
        "--extra-proteins",
        nargs="*",
        default=[],
        help="Protein names missing from the donor DB, appended in order "
        "(e.g. PF01139.17 for the xanthodb master — reference "
        "tests/pfaai_tests.hpp TESTDB_PROTEIN_SET lists it last)",
    )
    p.add_argument(
        "--donor-metadata-db",
        nargs="*",
        default=[],
        help="DBs contributing true genome_length/genome_class/SCP_score values",
    )
    args = p.parse_args(argv)
    names = genome_names_from_csv_header(args.genome_names_csv)
    prots = protein_names_from_db(args.proteins_from_db) + args.extra_proteins
    rebuild_master_db(
        args.dst_db, args.f_array, args.lc_array, names, prots,
        donor_dbs=args.donor_metadata_db,
    )
    print(f"Wrote {args.dst_db}: {len(names)} genomes x {len(prots)} proteins")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
