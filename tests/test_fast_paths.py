"""Routing and robustness of the fast/banded engine paths: the
query-subset rectangle, banded-engine edge cases, block-engine cache
identity, and the host/device dispatch rule."""

import numpy as np
import pytest

import parfastaai_jax.engine as engine
from parfastaai_jax.engine import (
    _banded_sn,
    _choose_block_engine,
    compute,
    compute_fast,
    compute_streamed,
)
from parfastaai_jax.etl.database import SCPDatabase
from parfastaai_jax.modes import all_vs_all, query_subset


@pytest.fixture(scope="module")
def combo(combo12_db):
    db = SCPDatabase(combo12_db)
    pres = db.load_presence()
    db.close()
    return db.meta, pres


def test_compute_fast_qsub_routes_rectangle(combo, monkeypatch):
    """Query-subset --fast must do |Q| x G work, not the G x G square
    (reference ds_impl.hpp:251-263)."""
    meta, pres = combo
    queries = [meta.genome_set[i] for i in (0, 2, 5)]
    pairs = query_subset(meta, queries)
    g = len(meta.genome_set)

    shapes = []
    real = engine._banded_sn

    def spy(presence, row_ids, col_ids, *args, **kwargs):
        shapes.append((len(row_ids), len(col_ids)))
        return real(presence, row_ids, col_ids, *args, **kwargs)

    monkeypatch.setattr(engine, "_banded_sn", spy)
    fast = compute_fast(pres, pairs)
    assert shapes == [(len(queries), g)]  # rectangle, not (g, g)

    exact = compute(pres, pairs)
    np.testing.assert_allclose(fast.s, exact.s, rtol=1e-5)
    np.testing.assert_array_equal(fast.n, exact.n)
    np.testing.assert_array_equal(fast.genome_a, exact.genome_a)
    np.testing.assert_array_equal(fast.genome_b, exact.genome_b)


def test_compute_fast_all_vs_all_not_rerouted(combo, monkeypatch):
    """All-vs-all keeps its existing square paths (row set == all genomes)."""
    meta, pres = combo
    pairs = all_vs_all(meta)

    def boom(*args, **kwargs):  # the XLA fallback must not call _banded_sn
        raise AssertionError("square all-vs-all must not take the rect path")

    monkeypatch.setattr(engine, "_banded_sn", boom)
    fast = compute_fast(pres, pairs)
    exact = compute(pres, pairs)
    np.testing.assert_allclose(fast.s, exact.s, rtol=1e-5)


def test_banded_sn_empty_axes(combo):
    """Empty row/col id lists return zero-shaped matrices, not a range()
    error."""
    _, pres = combo
    ids = np.arange(3, dtype=np.int32)
    empty = np.empty(0, dtype=np.int32)
    for rows, cols in ((empty, ids), (ids, empty), (empty, empty)):
        s, n = _banded_sn(pres, rows, cols, rows, cols)
        assert s.shape == (len(rows), len(cols))
        assert n.shape == (len(rows), len(cols))


def test_banded_sn_bounded_pending_matches(combo):
    """The depth-bounded drain returns the same matrices as a full-matrix
    fused computation (the device residency bound must not change
    results)."""
    _, pres = combo
    g = pres.m.shape[1]
    ids = np.arange(g, dtype=np.int32)
    # band/col_chunk of 2 forces many blocks -> the drain loop runs.
    s, n = _banded_sn(
        pres, ids, ids, ids, ids, band=2, col_chunk=2, 
    )
    s1, n1 = _banded_sn(pres, ids, ids, ids, ids)
    np.testing.assert_allclose(s, s1, rtol=1e-6)
    np.testing.assert_array_equal(n, n1)


def test_block_engine_cache_resolves_use_pallas(combo):
    """Repeated engine requests for one presence share one cache entry — no
    duplicate presence-bucket uploads — and the resident and staged
    engines are distinct entries."""
    _, pres = combo
    resident = _choose_block_engine(pres, staged=False)
    assert _choose_block_engine(pres, staged=False) is resident
    assert _choose_block_engine(pres, staged=None) is resident  # no budget
    assert _choose_block_engine(pres, staged=True) is not resident


def test_streamed_empty_query_axis(combo, tmp_path):
    """Zero rows degrade to a header-only CSV."""
    meta, pres = combo
    out = tmp_path / "empty.csv"
    compute_streamed(
        pres,
        np.empty(0, np.int32),
        np.arange(len(meta.genome_set), dtype=np.int32),
        str(out),
        (),
        meta.genome_set,
    )
    lines = out.read_text().splitlines()
    assert lines == ["," + ",".join(meta.genome_set)]


def test_host_work_limit_env(combo, monkeypatch):
    _, pres = combo
    monkeypatch.delenv("PARFASTAAI_FORCE_DEVICE", raising=False)
    monkeypatch.setenv("PARFASTAAI_HOST_WORK_LIMIT", "0")
    assert not engine._use_host(pres)
    monkeypatch.setenv("PARFASTAAI_HOST_WORK_LIMIT", "1e18")
    assert engine._use_host(pres)


def test_use_host_is_the_mac_threshold_on_every_backend(combo, monkeypatch):
    """The host/device choice is the plain HOST_WORK_LIMIT rule whatever the
    backend: no wire probe, no calibration file, no device contact."""
    _, pres = combo
    monkeypatch.delenv("PARFASTAAI_FORCE_DEVICE", raising=False)
    monkeypatch.delenv("PARFASTAAI_HOST_WORK_LIMIT", raising=False)
    P, G, K = pres.m.shape
    macs = P * G * G * K
    for backend in ("cpu", "gpu"):
        monkeypatch.setattr(engine.jax, "default_backend", lambda b=backend: b)
        monkeypatch.setattr(engine, "HOST_WORK_LIMIT", macs)
        assert engine._use_host(pres)
        monkeypatch.setattr(engine, "HOST_WORK_LIMIT", macs - 1)
        assert not engine._use_host(pres)


def test_force_device_env_beats_the_threshold(combo, monkeypatch):
    _, pres = combo
    monkeypatch.setenv("PARFASTAAI_HOST_WORK_LIMIT", "1e18")
    assert engine._use_host(pres)
    monkeypatch.setenv("PARFASTAAI_FORCE_DEVICE", "1")
    assert not engine._use_host(pres)
