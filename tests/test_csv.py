"""CSV output byte-parity vs the bundled golden CSVs (reference printOutput,
src/main.cpp:133-175; goldens data/*_aji_matrix_wheader.csv)."""

import numpy as np
import pytest

from parfastaai_jax.engine import compute
from parfastaai_jax.etl.database import SCPDatabase
from parfastaai_jax.io.csv_writer import write_aji_csv
from parfastaai_jax.io.fmtfloat import format_double
from parfastaai_jax.modes import all_vs_all


@pytest.mark.parametrize("name", ["xdb_subset1", "xdb_subset2"])
def test_csv_byte_parity(goldens, tmp_path, name):
    db = SCPDatabase(f"{goldens}/{name}.db")
    pres = db.load_presence()
    db.close()
    pairs = all_vs_all(db.meta)
    result = compute(pres, pairs)
    out = tmp_path / "out.csv"
    write_aji_csv(str(out), pairs, result.aji)
    ours = out.read_bytes()
    ref = open(f"{goldens}/{name}_aji_matrix_wheader.csv", "rb").read()
    assert ours == ref


def test_format_double_fmt_compat():
    assert format_double(0.0) == "0"
    assert format_double(1.0) == "1"
    assert format_double(-0.0) == "-0"
    assert format_double(0.9468103868455618) == "0.9468103868455618"
    assert format_double(float("nan")) == "nan"
    assert format_double(np.float64(0.5)) == "0.5"
