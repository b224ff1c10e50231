"""Property tests: the engine vs a direct set-based AJI oracle on random data.

The oracle mirrors the reference semantics literally: per (protein, pair),
J = |A ∩ B| / (|A| + |B| - |A ∩ B|) accumulated in ascending protein order,
counting only non-empty intersections (algorithm_impl.hpp:240-271).  Exact
f64 in the same operation order => bit-for-bit equality with the engine."""

import numpy as np
import pytest

from parfastaai_jax.engine import compute, jaccard_finish
from parfastaai_jax.etl.database import PresenceData
from parfastaai_jax.modes import PairSpace
from parfastaai_jax.types import DBMetaData


def _random_presence(P, G, K, density, seed):
    rng = np.random.default_rng(seed)
    m = (rng.random((P, G, K)) < density).astype(np.uint8)
    # Make some proteins entirely absent from some genomes.
    absent = rng.random((P, G)) < 0.15
    m[absent] = 0
    t = m.sum(axis=2, dtype=np.int32)
    meta = DBMetaData(
        protein_set=tuple(f"P{i}" for i in range(P)),
        genome_set=tuple(f"g{i}" for i in range(G)),
    )
    return PresenceData(
        meta=meta,
        m=m,
        t=t,
        widths=np.full(P, K, np.int32),
        tetramer_ids=[np.arange(K, dtype=np.int32)] * P,
    )


def _oracle(m, a, b):
    P = m.shape[0]
    s, n = 0.0, 0
    for p in range(P):
        sa = set(np.flatnonzero(m[p, a]).tolist())
        sb = set(np.flatnonzero(m[p, b]).tolist())
        inter = len(sa & sb)
        if inter > 0:
            s += inter / (len(sa) + len(sb) - inter)
            n += 1
    return s, n


def _pairs(meta, a, b):
    a = np.asarray(a, np.int32)
    b = np.asarray(b, np.int32)
    g = len(meta.genome_set)
    return PairSpace(
        db_a=a, db_b=b, jac_a=a, jac_b=b, denom_a=a, denom_b=b,
        out_row=a, out_col=b,
        mirror_row=np.full_like(a, -1), mirror_col=np.full_like(a, -1),
        query_names=meta.genome_set, target_names=meta.genome_set,
        row_db_ids=np.arange(g, dtype=np.int32),
        col_db_ids=np.arange(g, dtype=np.int32),
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("density", [0.02, 0.3, 0.9])
def test_engine_matches_set_oracle(seed, density):
    P, G, K = 7, 9, 130
    pres = _random_presence(P, G, K, density, seed)
    a, b = np.triu_indices(G, k=1)
    result = compute(pres, _pairs(pres.meta, a, b))
    for i in range(len(a)):
        s, n = _oracle(pres.m, a[i], b[i])
        assert result.n[i] == n
        assert result.s[i] == s  # exact f64: same op order
        if n == 0:
            assert np.isnan(result.aji[i])


def test_empty_intersection_pair_gives_nan():
    """Two genomes sharing no protein at all: N == 0 -> AJI NaN
    (reference algorithm_impl.hpp:318 divides S/N with N == 0)."""
    pres = _random_presence(3, 4, 64, 0.5, 3)
    pres.m[:, 2, :] = 0  # genome 2 has nothing
    pres.t[:, 2] = 0
    result = compute(pres, _pairs(pres.meta, [0, 2], [2, 3]))
    assert (result.n == 0).all()
    assert np.isnan(result.aji).all()


def test_jaccard_finish_matches_oracle_large_random():
    rng = np.random.default_rng(7)
    P, n = 80, 512
    counts = rng.integers(0, 300, size=(P, n)).astype(np.int32)
    counts[rng.random((P, n)) < 0.4] = 0
    ta = counts + rng.integers(1, 100, size=(P, n)).astype(np.int32)
    tb = counts + rng.integers(1, 100, size=(P, n)).astype(np.int32)
    s, nn = jaccard_finish(counts, ta, tb)
    for i in rng.choice(n, 32, replace=False):
        acc, cnt = 0.0, 0
        for p in range(P):
            c = int(counts[p, i])
            if c > 0:
                acc += c / (int(ta[p, i]) + int(tb[p, i]) - c)
                cnt += 1
        assert s[i] == acc
        assert nn[i] == cnt
