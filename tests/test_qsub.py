"""Query-subset mode semantics.

The reference's query-subset goldens (xdb_qry_subset_*.bin) require its
stripped master DB, so this file validates the mode by cross-consistency
instead: Jaccard of a genome pair depends only on that pair's tetramer
sets, so the query-subset AJI values over the combo12 DB must equal the
corresponding all-vs-all values over the same DB — and, for pairs inside
subset1, the plain f64 oracle over subset1's own database."""

import numpy as np
import pytest

from parfastaai_jax.engine import compute
from parfastaai_jax.etl.database import SCPDatabase
from parfastaai_jax.modes import all_vs_all, query_subset
from parfastaai_jax.types import PFAAIError


@pytest.fixture(scope="module")
def combo(combo12_db):
    db = SCPDatabase(combo12_db)
    pres = db.load_presence()
    db.close()
    return db.meta, pres


def test_qsub_consistent_with_all_vs_all(combo):
    meta, pres = combo
    queries = [meta.genome_set[i] for i in (0, 2, 5)]
    qpairs = query_subset(meta, queries)
    qres = compute(pres, qpairs)

    apairs = all_vs_all(meta)
    ares = compute(pres, apairs)
    full = {}
    for a, b, v in zip(ares.genome_a, ares.genome_b, ares.aji):
        full[(int(a), int(b))] = v
        full[(int(b), int(a))] = v

    assert qres.n_pairs == 3 * 5 + 3  # |Q|*|T'| + C(|Q|,2)
    for a, b, v in zip(qres.genome_a, qres.genome_b, qres.aji):
        assert v == full[(int(a), int(b))]


def test_qsub_pair_layout(combo):
    """Slot order: Q x T' row-major (query-file order x DB order of
    non-queries), then the Q x Q triangle in query-file order
    (ds_impl.hpp:251-263, 278-305)."""
    meta, _ = combo
    queries = [meta.genome_set[5], meta.genome_set[1]]  # out of DB order
    pairs = query_subset(meta, queries)
    tgt = [i for i in range(len(meta.genome_set)) if i not in (5, 1)]
    expect_a = [5] * len(tgt) + [1] * len(tgt) + [5]
    expect_b = tgt + tgt + [1]
    np.testing.assert_array_equal(pairs.jac_a, expect_a)
    np.testing.assert_array_equal(pairs.jac_b, expect_b)
    # CSV scatter: rows follow query-file order; mirror only for query pairs.
    assert pairs.query_names == (meta.genome_set[5], meta.genome_set[1])
    assert (pairs.mirror_row[:-1] == -1).all() and pairs.mirror_row[-1] == 1


def test_qsub_matches_subset1_goldens(combo, subset1_db):
    """Pairs drawn from subset1's genomes give the subset1 all-vs-all AJI
    (the plain f64 oracle over subset1's own database)."""
    from oracle import aji_matrix

    meta, pres = combo
    s1 = SCPDatabase(subset1_db)
    s1_names = s1.meta.genome_set
    s1.close()
    name_to_id = {n: i for i, n in enumerate(meta.genome_set)}
    assert all(n in name_to_id for n in s1_names)

    pairs = query_subset(meta, list(s1_names))
    res = compute(pres, pairs)
    aji_by_pair = {}
    for a, b, v in zip(res.genome_a, res.genome_b, res.aji):
        aji_by_pair[frozenset((int(a), int(b)))] = v

    want = aji_matrix(subset1_db)
    for i in range(len(s1_names)):
        for j in range(i + 1, len(s1_names)):
            key = frozenset((name_to_id[s1_names[i]], name_to_id[s1_names[j]]))
            assert aji_by_pair[key] == want[i, j]


def test_qsub_bad_query_rejected(combo):
    meta, _ = combo
    with pytest.raises(PFAAIError):
        query_subset(meta, [meta.genome_set[0], "not_a_genome.fna.gz"])


def test_duplicate_query_names_rejected(combo):
    """Deliberate divergence from the reference (PARITY.md quirks): the
    reference's validate_subset (src/main.cpp:204-232) accepts duplicate
    query names and builds a layout with repeated rows; we reject them."""
    meta, _ = combo
    with pytest.raises(PFAAIError, match="[Dd]uplicate"):
        query_subset(meta, [meta.genome_set[0], meta.genome_set[0]])
