"""Width bucketing of the presence tensor (etl.database.bucketize_presence)."""

import numpy as np
import pytest

from parfastaai_jax.engine import compute, compute_fast
from parfastaai_jax.etl.database import SCPDatabase, bucketize_presence
from parfastaai_jax.modes import all_vs_all


@pytest.fixture(scope="module")
def combo(combo12_db):
    db = SCPDatabase(combo12_db)
    pres = db.load_presence()
    db.close()
    return db.meta, pres


def test_buckets_partition_proteins(combo):
    _, pres = combo
    buckets = bucketize_presence(pres, max_buckets=4)
    assert 1 <= len(buckets) <= 4
    all_idx = np.concatenate([idx for idx, _, _ in buckets])
    assert sorted(all_idx.tolist()) == list(range(pres.m.shape[0]))
    for idx, m_b, t_b in buckets:
        kb = m_b.shape[2]
        assert kb % 128 == 0
        assert (pres.widths[idx] <= kb).all()
        # Slices carry the full data: rowsums must still equal T.
        np.testing.assert_array_equal(m_b.sum(axis=2, dtype=np.int32), t_b)


def test_buckets_cut_padded_work(combo):
    _, pres = combo
    buckets = bucketize_presence(pres, max_buckets=4)
    full = pres.m.shape[0] * pres.m.shape[2]
    bucketed = sum(m_b.shape[0] * m_b.shape[2] for _, m_b, _ in buckets)
    # combo12 widths span 66..818: bucketing must at least halve padded work.
    assert bucketed < 0.55 * full


def test_compute_fast_bucketed_matches_exact(combo):
    meta, pres = combo
    pairs = all_vs_all(meta)
    exact = compute(pres, pairs)
    fast = compute_fast(pres, pairs)
    np.testing.assert_array_equal(fast.n, exact.n)
    np.testing.assert_allclose(fast.aji, exact.aji, rtol=1e-6)


def test_single_bucket_degenerate():
    """Uniform widths => one bucket, identical tensor."""
    from parfastaai_jax.etl.database import PresenceData
    from parfastaai_jax.types import DBMetaData

    rng = np.random.default_rng(0)
    m = (rng.random((5, 6, 128)) < 0.5).astype(np.uint8)
    pres = PresenceData(
        meta=DBMetaData(protein_set=("a",) * 5, genome_set=("g",) * 6),
        m=m,
        t=m.sum(axis=2, dtype=np.int32),
        widths=np.full(5, 128, np.int32),
        tetramer_ids=[np.arange(128, dtype=np.int32)] * 5,
    )
    buckets = bucketize_presence(pres)
    assert len(buckets) == 1
    np.testing.assert_array_equal(buckets[0][1], m[buckets[0][0]])


def _wide_presence(width=32900, P=2, G=8):
    from parfastaai_jax.etl.database import PresenceData
    from parfastaai_jax.types import DBMetaData

    rng = np.random.default_rng(3)
    m = (rng.random((P, G, width)) < 0.05).astype(np.uint8)
    return PresenceData(
        meta=DBMetaData(
            protein_set=tuple(f"p{i}" for i in range(P)),
            genome_set=tuple(f"g{i}" for i in range(G)),
        ),
        m=m,
        t=m.sum(axis=2, dtype=np.int32),
        widths=np.full(P, width, np.int32),
        tetramer_ids=[np.arange(width, dtype=np.int32)] * P,
    )


def test_wide_buckets_prealign_to_k_block():
    """Buckets of any width come out of the HOST-side plan aligned to LANE
    (a whole number of the int8 matmul's 32-deep contraction steps), so the
    device never pads K — a device-side pad of a multi-GB slab
    materializes a whole copy of it."""
    from parfastaai_jax.constants import LANE
    from parfastaai_jax.etl.database import bucket_bounds

    pres = _wide_presence()
    _, bounds = bucket_bounds(pres.widths)
    assert len(bounds) == 1
    kb = bounds[0][2]
    assert LANE % 32 == 0
    assert kb % LANE == 0 and 32900 <= kb < 32900 + LANE
    # bucketize pads the slice past the tensor's own width with zeros.
    buckets = bucketize_presence(pres)
    idx, m_b, t_b = buckets[0]
    assert m_b.shape[2] == kb
    np.testing.assert_array_equal(m_b[:, :, : pres.m.shape[2]], pres.m[idx])
    assert not m_b[:, :, pres.m.shape[2] :].any()
    np.testing.assert_array_equal(m_b.sum(axis=2, dtype=np.int32), t_b)


def test_staged_slab_fetch_pads_and_bounds_memory(monkeypatch):
    """The slab store gathers into the padded width (zeros past the
    tensor's edge) and evicts BEFORE uploading, so the cap is never
    transiently exceeded by a new slab (beyond the >=2 live-slab floor)."""
    from parfastaai_jax.engine import _slab_store
    from parfastaai_jax.etl.database import bucket_bounds

    pres = _wide_presence()
    _, bounds = bucket_bounds(pres.widths)
    k0, i0, kb = bounds[0]
    order = np.argsort(pres.widths, kind="stable").astype(np.int32)
    idx = order[k0:i0]
    monkeypatch.setenv("PARFASTAAI_HBM_BYTES", "1")  # cap floor: churn
    fetch = _slab_store(pres)
    ids_a = np.arange(4, dtype=np.int32)
    ids_b = np.arange(4, 8, dtype=np.int32)
    slab_a = np.asarray(fetch(0, idx, kb, ids_a))
    slab_b = np.asarray(fetch(0, idx, kb, ids_b))
    for slab, ids in ((slab_a, ids_a), (slab_b, ids_b)):
        assert slab.shape == (len(idx), len(ids), kb)
        np.testing.assert_array_equal(
            slab[:, :, : pres.m.shape[2]], pres.m[np.ix_(idx, ids)]
        )
        assert not slab[:, :, pres.m.shape[2] :].any()
