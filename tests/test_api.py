"""Public library API (parfastaai_jax.api) vs the CLI's golden outputs."""

import numpy as np
import pytest

import parfastaai_jax.api as pfa
from parfastaai_jax.types import PFAAIError


def test_aji_all_vs_all_matches_golden_csv(subset1_db, subset1_csv, tmp_path):
    res = pfa.aji(subset1_db)
    out = tmp_path / "api.csv"
    res.to_csv(str(out))
    assert out.read_bytes() == subset1_csv
    # matrix == the parsed CSV values
    g = len(res.row_names)
    parsed = np.genfromtxt(
        out, delimiter=",", skip_header=1, usecols=range(1, g + 1)
    )
    np.testing.assert_array_equal(res.matrix, parsed)
    assert res.row_names == res.col_names
    assert res.pairs.n_pairs == g * (g - 1) // 2


def test_aji_two_database_and_compat_flag(subset1_db, subset2_db):
    res = pfa.aji(subset1_db, query_db=subset2_db)
    res_nc = pfa.aji(subset1_db, query_db=subset2_db, compat_qt_t_swap=False)
    assert res.matrix.shape == res_nc.matrix.shape == (4, 4)
    assert not np.array_equal(res.matrix, res_nc.matrix)  # the quirk is real


def test_aji_query_subset_unknown_genome_raises(combo12_db):
    with pytest.raises(PFAAIError):
        pfa.aji(combo12_db, query_subset=["no_such_genome"])


def test_aji_query_db_and_subset_mutually_exclusive(subset1_db, subset2_db):
    with pytest.raises(PFAAIError):
        pfa.aji(subset1_db, query_db=subset2_db, query_subset=["x"])


def test_aji_unknown_engine_raises(subset1_db):
    with pytest.raises(PFAAIError):
        pfa.aji(subset1_db, engine="warp")


def test_aji_to_csv_streamed_matches_exact(subset1_db, tmp_path):
    exact = tmp_path / "exact.csv"
    streamed = tmp_path / "streamed.csv"
    pfa.aji_to_csv(str(exact), subset1_db)
    pfa.aji_to_csv(str(streamed), subset1_db, engine="streamed", band=2)
    g = 4
    a = np.genfromtxt(exact, delimiter=",", skip_header=1, usecols=range(1, g + 1))
    b = np.genfromtxt(
        streamed, delimiter=",", skip_header=1, usecols=range(1, g + 1)
    )
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)


def test_aji_fast_engine_close_to_exact(subset1_db):
    res = pfa.aji(subset1_db)
    fast = pfa.aji(subset1_db, engine="fast")
    np.testing.assert_allclose(fast.matrix, res.matrix, rtol=1e-6, atol=1e-7)


def test_aji_to_csv_streamed_exact(subset1_db, subset1_csv, tmp_path):
    """engine="streamed-exact" is byte-identical to the golden CSV."""
    import parfastaai_jax.api as pfa

    out = tmp_path / "se.csv"
    pfa.aji_to_csv(str(out), subset1_db, engine="streamed-exact", band=2)
    assert out.read_bytes() == subset1_csv


def test_streamed_exact_rejects_contradictory_args(subset1_db, tmp_path):
    """engine='streamed-exact' takes no kernel-divide arguments (the CLI has
    none either; the two front doors must agree).  ``mesh`` composes: the
    mesh-sharded count production is byte-identical."""
    import pytest

    import parfastaai_jax.api as pfa

    out = str(tmp_path / "o.csv")
    for kw in ({"approx": True}, {"precise": True}):
        with pytest.raises(TypeError):
            pfa.aji_to_csv(out, subset1_db, engine="streamed-exact", **kw)
    # mesh is accepted and byte-identical to the meshless banded run.
    ref = str(tmp_path / "ref.csv")
    pfa.aji_to_csv(ref, subset1_db, engine="streamed-exact")
    pfa.aji_to_csv(out, subset1_db, engine="streamed-exact", mesh=(2, 2))
    assert open(out, "rb").read() == open(ref, "rb").read()


def test_api_staged_passthrough(subset1_db, tmp_path, monkeypatch):
    """The library API exposes the CLI's --staged: fast and streamed
    engines accept staged=True and produce the same values as resident."""
    import numpy as np

    import parfastaai_jax.api as pfa

    monkeypatch.setenv("PARFASTAAI_FORCE_DEVICE", "1")
    resident = pfa.aji(subset1_db, engine="fast", staged=False)
    monkeypatch.setenv("PARFASTAAI_HBM_BYTES", "1")
    staged = pfa.aji(subset1_db, engine="fast", staged=True)
    np.testing.assert_array_equal(staged.matrix, resident.matrix)

    out_r = tmp_path / "resident.csv"
    out_s = tmp_path / "staged.csv"
    monkeypatch.delenv("PARFASTAAI_HBM_BYTES")
    pfa.aji_to_csv(str(out_r), subset1_db, engine="streamed", staged=False)
    monkeypatch.setenv("PARFASTAAI_HBM_BYTES", "1")
    pfa.aji_to_csv(str(out_s), subset1_db, engine="streamed", staged=True)
    assert out_s.read_bytes() == out_r.read_bytes()
