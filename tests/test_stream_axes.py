"""StreamAxes: the O(rows + cols) pair-space surface of the streamed engine
(--streamed must not materialize O(G^2) host arrays)."""

import time

import numpy as np
import pytest

from parfastaai_jax.etl.database import QueryTargetDatabase, SCPDatabase
from parfastaai_jax.modes import (
    all_vs_all,
    all_vs_all_axes,
    query_subset,
    query_subset_axes,
    query_target,
    query_target_axes,
)
from parfastaai_jax.types import DBMetaData, PFAAIError

AXIS_FIELDS = (
    "query_names",
    "target_names",
    "row_db_ids",
    "col_db_ids",
    "row_denom_ids",
    "col_denom_ids",
)


def _assert_axes_match(axes, pairs):
    for f in AXIS_FIELDS:
        a, b = getattr(axes, f), getattr(pairs, f)
        if isinstance(a, tuple):
            assert a == b, f
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)


def test_all_vs_all_axes_match(combo12_db):
    db = SCPDatabase(combo12_db)
    db.close()
    _assert_axes_match(all_vs_all_axes(db.meta), all_vs_all(db.meta))


def test_query_subset_axes_match(combo12_db):
    db = SCPDatabase(combo12_db)
    db.close()
    queries = [db.meta.genome_set[i] for i in (5, 1)]
    _assert_axes_match(
        query_subset_axes(db.meta, queries), query_subset(db.meta, queries)
    )
    with pytest.raises(PFAAIError):
        query_subset_axes(db.meta, ["nope.fna.gz"])
    with pytest.raises(PFAAIError, match="[Dd]uplicate"):
        query_subset_axes(db.meta, [queries[0], queries[0]])


@pytest.mark.parametrize("compat", [True, False])
def test_query_target_axes_match(subset1_db, subset2_db, compat):
    db = QueryTargetDatabase(subset1_db, subset2_db)
    db.close()
    _assert_axes_match(
        query_target_axes(db.meta, compat_qt_t_swap=compat),
        query_target(db.meta, compat_qt_t_swap=compat),
    )


def test_axes_are_linear_at_large_g():
    """G = 65,536 axes construct instantly in O(G): the materialized
    PairSpace here would need ten ~8.6 GB int32 columns (2^31 pairs) and is
    exactly what would be fatal at large G."""
    g = 65536
    names = tuple(f"g{i:05d}.fna.gz" for i in range(g))
    meta = DBMetaData(protein_set=("P1",), genome_set=names)
    t0 = time.perf_counter()
    axes = all_vs_all_axes(meta)
    elapsed = time.perf_counter() - t0
    assert elapsed < 1.0
    total_bytes = sum(
        getattr(axes, f).nbytes
        for f in AXIS_FIELDS
        if isinstance(getattr(axes, f), np.ndarray)
    )
    assert total_bytes <= 6 * g * 4  # six O(G) int32 vectors, nothing more
