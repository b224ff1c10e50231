"""Golden-archive writers: read -> write reproduces every bundled reference
archive byte-for-byte (reference cereal hooks
interface.hpp:72-74, utils.hpp:285-287), so new fixtures pinned with the
writers are loadable by the rebuilt reference binary."""

from __future__ import annotations

import numpy as np
import pytest

from parfastaai_jax.etl import goldens as golden_io


def _bytes(path) -> bytes:
    return open(path, "rb").read()


@pytest.mark.parametrize(
    "name", ["xanthodb_lc_array.bin", "xanthodb_lp_array.bin"]
)
def test_i32_vector_roundtrip(goldens, tmp_path, name):
    vec = golden_io.read_i32_vector(f"{goldens}/{name}")
    out = tmp_path / name
    golden_io.write_i32_vector(out, vec)
    assert _bytes(out) == _bytes(f"{goldens}/{name}")


@pytest.mark.parametrize(
    "name", ["xanthodb_aji.bin", "xdb_subset1_aji.bin", "xdb_qt_aji.bin"]
)
def test_f64_vector_roundtrip(goldens, tmp_path, name):
    vec = golden_io.read_f64_vector(f"{goldens}/{name}")
    out = tmp_path / name
    golden_io.write_f64_vector(out, vec)
    assert _bytes(out) == _bytes(f"{goldens}/{name}")


def test_pair_vector_roundtrip(goldens, tmp_path):
    pairs = golden_io.read_pair_vector(f"{goldens}/xanthodb_f_array.bin")
    out = tmp_path / "f.bin"
    golden_io.write_pair_vector(out, pairs)
    assert _bytes(out) == _bytes(f"{goldens}/xanthodb_f_array.bin")


@pytest.mark.parametrize(
    "name", ["xdb_subset1_sorted_e_array.bin", "xdb_qt_sorted_e_array.bin"]
)
def test_triple_vector_roundtrip(goldens, tmp_path, name):
    triples = golden_io.read_triple_vector(f"{goldens}/{name}")
    out = tmp_path / name
    golden_io.write_triple_vector(out, triples)
    assert _bytes(out) == _bytes(f"{goldens}/{name}")


@pytest.mark.parametrize(
    "name", ["xanthodb_jac.bin", "xdb_qry_subset_jac.bin", "xdb_qt_jac.bin"]
)
def test_jac_vector_roundtrip(goldens, tmp_path, name):
    jac = golden_io.read_jac_vector(f"{goldens}/{name}")
    out = tmp_path / name
    golden_io.write_jac_vector(
        out, jac["genome_a"], jac["genome_b"], jac["s"], jac["n"]
    )
    assert _bytes(out) == _bytes(f"{goldens}/{name}")


@pytest.mark.parametrize(
    "name", ["xanthodb_t_matrix.bin", "xdb_qt_t_matrix.bin"]
)
def test_dmatrix_roundtrip(goldens, tmp_path, name):
    mat = golden_io.read_dmatrix_i32(f"{goldens}/{name}")
    out = tmp_path / name
    golden_io.write_dmatrix_i32(out, mat)
    assert _bytes(out) == _bytes(f"{goldens}/{name}")


def test_write_new_fixture_roundtrip(tmp_path):
    """Writers work for NEW data (not just re-serialization): arbitrary
    arrays survive a write -> read cycle exactly."""
    rng = np.random.default_rng(7)
    vec = rng.integers(-(2**31), 2**31 - 1, size=100, dtype=np.int32)
    golden_io.write_i32_vector(tmp_path / "v.bin", vec)
    np.testing.assert_array_equal(
        golden_io.read_i32_vector(tmp_path / "v.bin"), vec
    )
    f64 = rng.random(57)
    golden_io.write_f64_vector(tmp_path / "f.bin", f64)
    np.testing.assert_array_equal(
        golden_io.read_f64_vector(tmp_path / "f.bin"), f64
    )
    mat = rng.integers(0, 1000, size=(13, 29)).astype(np.int32)
    golden_io.write_dmatrix_i32(tmp_path / "m.bin", mat)
    np.testing.assert_array_equal(
        golden_io.read_dmatrix_i32(tmp_path / "m.bin"), mat
    )
    ga = rng.integers(0, 20, 11).astype(np.int32)
    gb = rng.integers(0, 20, 11).astype(np.int32)
    s = rng.random(11)
    n = rng.integers(0, 80, 11).astype(np.int32)
    golden_io.write_jac_vector(tmp_path / "j.bin", ga, gb, s, n)
    jac = golden_io.read_jac_vector(tmp_path / "j.bin")
    np.testing.assert_array_equal(jac["genome_a"], ga)
    np.testing.assert_array_equal(jac["genome_b"], gb)
    np.testing.assert_array_equal(jac["s"], s)
    np.testing.assert_array_equal(jac["n"], n)
