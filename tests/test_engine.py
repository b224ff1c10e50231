"""End-to-end numeric parity: JAC and AJI bit-for-bit vs goldens
(mirrors tests/pfaai_tests.cpp:355-454 compute_JAC_AJI — the reference
compares S within 1e-7 but AJI with exact double equality; we require exact
equality on both)."""

import numpy as np
import pytest

from parfastaai_jax.engine import compute
from parfastaai_jax.etl import goldens as golden_io
from parfastaai_jax.etl.database import QueryTargetDatabase, SCPDatabase
from parfastaai_jax.modes import all_vs_all, query_target


@pytest.mark.parametrize("name", ["xdb_subset1", "xdb_subset2"])
def test_all_vs_all_bit_for_bit(goldens, name):
    db = SCPDatabase(f"{goldens}/{name}.db")
    pres = db.load_presence()
    db.close()
    pairs = all_vs_all(db.meta)
    result = compute(pres, pairs)

    jac = golden_io.read_jac_vector(f"{goldens}/{name}_jac.bin")
    aji = golden_io.read_f64_vector(f"{goldens}/{name}_aji.bin")
    np.testing.assert_array_equal(result.genome_a, jac["genome_a"])
    np.testing.assert_array_equal(result.genome_b, jac["genome_b"])
    np.testing.assert_array_equal(result.n, jac["n"])
    np.testing.assert_array_equal(result.s, jac["s"])  # bit-for-bit
    np.testing.assert_array_equal(result.aji, aji)  # bit-for-bit


def test_qt_bit_for_bit(subset1_db, subset2_db, goldens):
    db = QueryTargetDatabase(subset1_db, subset2_db)
    pres = db.load_presence()
    db.close()
    pairs = query_target(db.meta)  # compat_qt_t_swap default on
    result = compute(pres, pairs)

    jac = golden_io.read_jac_vector(f"{goldens}/xdb_qt_jac.bin")
    aji = golden_io.read_f64_vector(f"{goldens}/xdb_qt_aji.bin")
    np.testing.assert_array_equal(result.genome_a, jac["genome_a"])
    np.testing.assert_array_equal(result.genome_b, jac["genome_b"])
    np.testing.assert_array_equal(result.n, jac["n"])
    np.testing.assert_array_equal(result.s, jac["s"])
    np.testing.assert_array_equal(result.aji, aji)


def test_qt_without_compat_swap_differs(subset1_db, subset2_db, goldens):
    """The corrected denominator must NOT match the quirk-baked goldens
    (documents that the compat flag is load-bearing; survey C12)."""
    db = QueryTargetDatabase(subset1_db, subset2_db)
    pres = db.load_presence()
    db.close()
    pairs = query_target(db.meta, compat_qt_t_swap=False)
    result = compute(pres, pairs)
    aji = golden_io.read_f64_vector(f"{goldens}/xdb_qt_aji.bin")
    assert not np.array_equal(result.aji, aji)
    # ... but it is close (the quirk swaps T columns of related genomes).
    np.testing.assert_allclose(result.aji, aji, atol=2e-2)


def test_unpack_bits_device_roundtrip():
    """Packed-bits upload path: np.packbits -> device unpack == original."""
    import numpy as np

    from parfastaai_jax.engine import _unpack_bits_device

    rng = np.random.default_rng(8)
    for k in (256, 250):  # multiple-of-8 and ragged tail
        m = (rng.random((3, 12, k)) < 0.3).astype(np.uint8)
        bits = np.packbits(m, axis=-1)
        out = np.asarray(_unpack_bits_device(bits, k))
        np.testing.assert_array_equal(out, m.astype(np.int8))
