"""Sanity checks of the cereal golden readers against known shapes
(survey-verified sizes; reference tests/pfaai_tests.cpp fixtures)."""

import numpy as np

from parfastaai_jax.etl import goldens as golden_io


def test_lc_lp_shapes(goldens):
    lc = golden_io.read_i32_vector(f"{goldens}/xdb_subset1_lc_array.bin")
    lp = golden_io.read_i32_vector(f"{goldens}/xdb_subset1_lp_array.bin")
    assert lc.shape == (160000,)
    assert lp.shape == (160000,)
    # Lp is the exclusive prefix sum of Lc.
    np.testing.assert_array_equal(lp[1:], np.cumsum(lc)[:-1])
    assert lp[0] == 0


def test_f_array(goldens):
    f = golden_io.read_pair_vector(f"{goldens}/xdb_subset1_f_array.bin")
    lc = golden_io.read_i32_vector(f"{goldens}/xdb_subset1_lc_array.bin")
    assert f.shape == (61905, 2)
    assert int(lc.sum()) == len(f)


def test_e_array(goldens):
    e = golden_io.read_triple_vector(f"{goldens}/xdb_subset1_sorted_e_array.bin")
    assert e.shape == (91830, 3)
    # Sorted by (genomeA, genomeB, proteinIndex) — interface.hpp:103-111.
    keys = e[:, 1].astype(np.int64) * 10**10 + e[:, 2] * 10**5 + e[:, 0]
    assert (np.diff(keys) >= 0).all()


def test_jac_and_aji(goldens):
    jac = golden_io.read_jac_vector(f"{goldens}/xdb_subset1_jac.bin")
    aji = golden_io.read_f64_vector(f"{goldens}/xdb_subset1_aji.bin")
    assert len(jac) == 6 and len(aji) == 6  # C(4,2) pairs
    np.testing.assert_array_equal(jac["s"] / jac["n"], aji)


def test_t_matrix(goldens):
    t = golden_io.read_dmatrix_i32(f"{goldens}/xdb_subset1_t_matrix.bin")
    assert t.shape == (79, 4)
    assert (t > 0).all()
