"""Lc/Lp/F/E derivation parity vs goldens (mirrors the reference's
construct_LFTE golden tests, tests/pfaai_tests.cpp:173-354, 576-652)."""

import numpy as np
import pytest

from parfastaai_jax.etl import goldens as golden_io
from parfastaai_jax.etl.database import QueryTargetDatabase, SCPDatabase
from parfastaai_jax.etl.derive import derive_qt, derive_single


@pytest.mark.parametrize("name", ["xdb_subset1", "xdb_subset2"])
def test_single_db_lcfe(goldens, name):
    db = SCPDatabase(f"{goldens}/{name}.db")
    lc, lp, f, e = derive_single(db)
    np.testing.assert_array_equal(
        lc, golden_io.read_i32_vector(f"{goldens}/{name}_lc_array.bin")
    )
    np.testing.assert_array_equal(
        lp, golden_io.read_i32_vector(f"{goldens}/{name}_lp_array.bin")
    )
    np.testing.assert_array_equal(
        f, golden_io.read_pair_vector(f"{goldens}/{name}_f_array.bin")
    )
    np.testing.assert_array_equal(
        e, golden_io.read_triple_vector(f"{goldens}/{name}_sorted_e_array.bin")
    )
    db.close()


def test_qt_lcfe(subset1_db, subset2_db, goldens):
    db = QueryTargetDatabase(subset1_db, subset2_db)
    lc, lp, f, e = derive_qt(db)
    np.testing.assert_array_equal(
        lc, golden_io.read_i32_vector(f"{goldens}/xdb_qt_lc_array.bin")
    )
    np.testing.assert_array_equal(
        lp, golden_io.read_i32_vector(f"{goldens}/xdb_qt_lp_array.bin")
    )
    np.testing.assert_array_equal(
        f, golden_io.read_pair_vector(f"{goldens}/xdb_qt_f_array.bin")
    )
    np.testing.assert_array_equal(
        e, golden_io.read_triple_vector(f"{goldens}/xdb_qt_sorted_e_array.bin")
    )
    db.close()
