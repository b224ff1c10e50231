"""Test harness configuration.

Pins the tests to the CPU backend with 8 virtual XLA devices, so the
multi-device sharding paths run and are validated on a machine with or
without a GPU.  Tests that need a GPU carry the ``gpu`` marker and skip
here; ``python chip_smoke.py`` exercises those paths on the card.

Database fixtures: ``subset1_db`` / ``subset2_db`` / ``combo12_db`` are the
reference's xdb fixture databases when PARFASTAAI_REFERENCE_DATA names the
reference's ``data/`` directory, and otherwise seeded synthetic databases
of the same layout: subset1 and subset2 are disjoint genome halves of one
synthetic master, and combo12 is the master.  Tests that compare against
the reference's golden files take the ``goldens`` fixture, which skips
when they are absent.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402

REFERENCE_DATA = os.environ.get("PARFASTAAI_REFERENCE_DATA", "")


@pytest.fixture(scope="session", autouse=True)
def _assert_cpu_backend():
    assert jax.devices()[0].platform == "cpu"
    assert jax.device_count() == 8


@pytest.fixture(scope="session")
def goldens() -> str:
    """The reference's data/ directory with its golden files; skips the
    test when it is not available."""
    if not (REFERENCE_DATA and os.path.isdir(REFERENCE_DATA)):
        pytest.skip(
            "reference golden files not available (set "
            "PARFASTAAI_REFERENCE_DATA to the reference's data/ directory)"
        )
    return REFERENCE_DATA


@pytest.fixture(scope="session")
def _fixture_dbs(tmp_path_factory) -> dict[str, str]:
    if REFERENCE_DATA and os.path.isdir(REFERENCE_DATA):
        return {
            name: os.path.join(REFERENCE_DATA, f"xdb_{name}.db")
            for name in ("subset1", "subset2", "subset_combo12")
        }
    import sqlite3

    from parfastaai_jax.tools.subset_db import build_subset_db
    from parfastaai_jax.tools.synth_db import generate

    d = tmp_path_factory.mktemp("synth_fixture_dbs")
    master = str(d / "xdb_subset_combo12.db")
    n_prot = 16
    # Per-protein pools from 40 to 800 tetramers (a 20x width spread, as in
    # real SCP databases) and a 0.9 chance per genome of carrying each
    # protein, so pairs share fewer than P proteins.
    pools = [int(round(40 * 20 ** (p / (n_prot - 1)))) for p in range(n_prot)]
    generate(
        master,
        n_genomes=8,
        n_proteins=n_prot,
        pool_size=pools,
        tetras_per_genome=[max(8, p // 3) for p in pools],
        seed=11,
        protein_coverage=0.9,
    )
    conn = sqlite3.connect(master)
    names = [r[0] for r in conn.execute("SELECT genome_name FROM genome_metadata")]
    conn.close()
    out = {"subset_combo12": master}
    for key, part in (("subset1", names[:4]), ("subset2", names[4:])):
        out[key] = str(d / f"xdb_{key}.db")
        build_subset_db(master, out[key], part)
    return out


@pytest.fixture(scope="session")
def subset1_db(_fixture_dbs) -> str:
    return _fixture_dbs["subset1"]


@pytest.fixture(scope="session")
def subset2_db(_fixture_dbs) -> str:
    return _fixture_dbs["subset2"]


@pytest.fixture(scope="session")
def combo12_db(_fixture_dbs) -> str:
    return _fixture_dbs["subset_combo12"]


@pytest.fixture(scope="session")
def subset1_csv(subset1_db) -> bytes:
    """Expected all-vs-all CSV bytes for ``subset1_db``: the reference's
    golden CSV where available, otherwise the plain f64 oracle's
    (tests/oracle.py)."""
    if REFERENCE_DATA and os.path.isdir(REFERENCE_DATA):
        path = os.path.join(REFERENCE_DATA, "xdb_subset1_aji_matrix_wheader.csv")
        with open(path, "rb") as fp:
            return fp.read()
    from oracle import aji_csv

    return aji_csv(subset1_db)
