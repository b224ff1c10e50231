"""Fused device paths: the XLA scan and the fast engine path, cross-checked
against the exact engine."""

import jax.numpy as jnp
import numpy as np
import pytest

from parfastaai_jax.engine import compute, compute_fast
from parfastaai_jax.etl.database import SCPDatabase
from parfastaai_jax.modes import all_vs_all
from parfastaai_jax.ops.fused import fused_aji, pair_counts_device


@pytest.fixture(scope="module")
def subset1(subset1_db):
    db = SCPDatabase(subset1_db)
    pres = db.load_presence()
    db.close()
    return db.meta, pres


def _rand_presence(P=5, G=12, K=256, density=0.2, seed=0):
    rng = np.random.default_rng(seed)
    m = (rng.random((P, G, K)) < density).astype(np.uint8)
    t = m.sum(axis=2, dtype=np.int32)
    return m, t


def test_pair_counts_device_matches_numpy():
    m, _ = _rand_presence()
    a, b = np.triu_indices(12, k=1)
    got = np.asarray(
        pair_counts_device(
            jnp.asarray(m), jnp.asarray(a.astype(np.int32)), jnp.asarray(b.astype(np.int32))
        )
    )
    want = np.einsum("pak,pbk->pab", m.astype(np.int64), m.astype(np.int64))[
        :, a, b
    ]
    np.testing.assert_array_equal(got, want)


def test_fused_aji_matches_exact(subset1):
    meta, pres = subset1
    pairs = all_vs_all(meta)
    exact = compute(pres, pairs)
    aji, s, n = fused_aji(jnp.asarray(pres.m), jnp.asarray(pres.t))
    aji = np.asarray(aji)
    n = np.asarray(n)
    got = aji[pairs.db_a, pairs.db_b]
    np.testing.assert_array_equal(n[pairs.db_a, pairs.db_b], exact.n)
    np.testing.assert_allclose(got, exact.aji, rtol=1e-6)
    # Symmetry and self-similarity.
    np.testing.assert_array_equal(aji, aji.T)
    np.testing.assert_allclose(np.diag(aji), 1.0, rtol=1e-6)


def test_compute_fast_matches_exact(subset1):
    meta, pres = subset1
    pairs = all_vs_all(meta)
    exact = compute(pres, pairs)
    fast = compute_fast(pres, pairs)
    np.testing.assert_array_equal(fast.n, exact.n)
    np.testing.assert_allclose(fast.aji, exact.aji, rtol=1e-6)


def test_banded_sn_matches_exact(subset1):
    """_banded_sn (the fused path's banded block engine, here on the XLA
    CPU backend) must reproduce the exact engine's S/N through its banding,
    padding, and host assembly — including non-divisible band/chunk sizes
    and distinct denominator columns."""
    from parfastaai_jax.engine import _banded_sn

    meta, pres = subset1
    pairs = all_vs_all(meta)
    exact = compute(pres, pairs)
    g = pres.m.shape[1]
    ids = np.arange(g, dtype=np.int32)
    s_mat, n_mat = _banded_sn(pres, ids, ids, ids, ids, band=3, col_chunk=3)
    np.testing.assert_array_equal(n_mat[pairs.db_a, pairs.db_b], exact.n)
    np.testing.assert_allclose(
        s_mat[pairs.db_a, pairs.db_b], exact.s, rtol=1e-6
    )
    # Rectangular slice with swapped denominator columns: against the exact
    # finish computed with the same denominators.
    rows = ids[:2]
    cols = ids[1:]
    dr, dc = ids[2:4], ids[:3]
    s_r, n_r = _banded_sn(pres, rows, cols, dr, dc, band=1, col_chunk=2)
    mf = pres.m.astype(np.float64)
    cnt = np.einsum("pik,pjk->pij", mf[:, rows], mf[:, cols])
    shared = cnt > 0
    denom = (
        pres.t[:, dr][:, :, None] + pres.t[:, dc][:, None, :] - cnt
    )
    with np.errstate(divide="ignore"):
        want_s = np.where(shared, cnt / denom, 0.0).sum(0)
    want_n = shared.sum(0)
    np.testing.assert_array_equal(n_r, want_n)
    np.testing.assert_allclose(s_r, want_s, rtol=1e-6)


def test_banded_sn_symmetric_skips_lower_blocks(monkeypatch):
    """Symmetric _banded_sn computes only diagonal-and-above blocks:
    10 of 16 at a 4x4 block grid, with the lower triangle filled from the
    transpose — values identical to the full walk."""
    import parfastaai_jax.engine as eng

    rng = np.random.default_rng(5)
    m = (rng.random((3, 32, 128)) < 0.25).astype(np.uint8)
    from parfastaai_jax.etl.database import PresenceData
    from parfastaai_jax.types import DBMetaData

    pres = PresenceData(
        meta=DBMetaData(
            protein_set=("a", "b", "c"),
            genome_set=tuple(f"g{i}" for i in range(32)),
        ),
        m=m,
        t=m.sum(axis=2, dtype=np.int32),
        widths=np.full(3, 128, dtype=np.int32),
        tetramer_ids=[np.arange(128, dtype=np.int32)] * 3,
    )
    monkeypatch.setenv("PARFASTAAI_FORCE_DEVICE", "1")
    calls = []
    orig = eng._choose_block_engine

    def counting(*a, **k):
        block_sn = orig(*a, **k)

        def wrapped(*ba, **bk):
            calls.append(1)
            return block_sn(*ba, **bk)

        return wrapped

    monkeypatch.setattr(eng, "_choose_block_engine", counting)
    ids = np.arange(32, dtype=np.int32)
    s_sym, n_sym = eng._banded_sn(pres, ids, ids, ids, ids, band=8,
                                  col_chunk=8)
    assert len(calls) == 10  # 4x4 grid: triu + diagonal only
    # Full walk for comparison: break symmetry detection via distinct
    # denominators that happen to be the same columns (a copy is not equal
    # by identity but IS by value — so use a genuinely different object
    # with equal values to confirm detection is by value, then a shifted
    # one for the full walk).
    calls.clear()
    s_sym2, n_sym2 = eng._banded_sn(pres, ids, ids, ids.copy(), ids.copy(),
                                    band=8, col_chunk=8)
    assert len(calls) == 10  # detection is by value, not identity
    np.testing.assert_array_equal(s_sym2, s_sym)
    # Reference: full square via an asymmetric-looking but value-equal walk
    # is impossible, so check against the exact oracle instead.
    mf = m.astype(np.float64)
    cnt = np.einsum("pik,pjk->pij", mf, mf)
    t64 = pres.t.astype(np.float64)
    denom = t64[:, :, None] + t64[:, None, :] - cnt
    with np.errstate(divide="ignore", invalid="ignore"):
        j = np.where(cnt > 0, cnt / denom, 0.0)
    np.testing.assert_array_equal(n_sym, (cnt > 0).sum(0))
    np.testing.assert_allclose(s_sym, j.sum(0), rtol=1e-6)
    np.testing.assert_array_equal(s_sym, s_sym.T)  # transpose fill exact


def _rand_block(P, A, B, K, density=0.3, seed=0):
    rng = np.random.default_rng(seed)
    ma = (rng.random((P, A, K)) < density).astype(np.int8)
    mb = (rng.random((P, B, K)) < density).astype(np.int8)
    return ma, mb, ma.sum(2, dtype=np.int32), mb.sum(2, dtype=np.int32)


def _f64_sn(ma, mb, ta, tb):
    cnt = np.einsum(
        "pak,pbk->pab", ma.astype(np.float64), mb.astype(np.float64)
    )
    denom = ta[:, :, None] + tb[:, None, :] - cnt
    with np.errstate(divide="ignore", invalid="ignore"):
        j = np.where(cnt > 0, cnt / denom, 0.0)
    return j.sum(0), (cnt > 0).sum(0)


@pytest.mark.parametrize(
    "P,A,B,K", [(3, 32, 32, 128), (4, 37, 21, 64), (2, 16, 48, 100),
                (2, 16, 16, 2048)]
)
def test_fused_sn_block_matches_f64_reference(P, A, B, K):
    """Ragged band shapes and widths, up to a wide K: N exact, S within the
    f32 sum of P terms each at most 1."""
    from parfastaai_jax.ops.fused import fused_sn_block

    ma, mb, ta, tb = _rand_block(P, A, B, K, seed=P + A + K)
    s, n = fused_sn_block(ma, mb, ta, tb)
    s64, n64 = _f64_sn(ma, mb, ta, tb)
    assert s.shape == (A, B) and n.shape == (A, B)
    np.testing.assert_array_equal(np.asarray(n), n64)
    np.testing.assert_allclose(np.asarray(s), s64, rtol=0, atol=P * 2**-24)


def test_fused_sn_block_empty_rows_give_zero():
    """All-zero genomes (the engines' band padding) contribute s == n == 0
    and no 0/0 NaN leaks through the select."""
    from parfastaai_jax.ops.fused import fused_sn_block

    ma, mb, ta, tb = _rand_block(2, 16, 16, 32)
    ma[:, 3] = 0
    ta[:, 3] = 0
    s, n = fused_sn_block(ma, mb, ta, tb)
    assert np.isfinite(np.asarray(s)).all()
    assert not np.asarray(s)[3].any() and not np.asarray(n)[3].any()


def test_jaccard_term_follows_exact_path_below_cnt():
    """Swapped (compat) denominators can fall to or below cnt; the device
    term is then what the f64 finish computes (inf, negative), not a
    clamped value, and cnt == 0 stays 0 even over a zero denominator."""
    import jax

    from parfastaai_jax.ops.fused import _jaccard

    cnt = np.array([3, 3, 3, 0, 0], np.int32)
    denom = np.array([6, 0, -2, 0, 5], np.int32)
    got = np.asarray(jax.jit(_jaccard)(cnt, denom))
    np.testing.assert_array_equal(
        got, np.array([0.5, np.inf, -1.5, 0.0, 0.0], np.float32)
    )
