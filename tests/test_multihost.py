"""Real multi-process execution: jax.distributed bootstrap + one-writer CSV.

Launches the actual CLI in two OS processes (4 virtual CPU devices each,
8 global) against a single-process 8-device run of the same mesh; the merged
CSV must be byte-identical, and only process 0 may write output files.
The multi-process analogue of the reference's shared-memory merge
(algorithm_impl.hpp:295-322) — here the merge is psum/allgather collectives
plus primary-gated IO (parallel/distributed.py)."""

import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(n_local_devices: int, extra: dict | None = None) -> dict:
    env = {
        **os.environ,
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": (
            f"--xla_force_host_platform_device_count={n_local_devices}"
        ),
    }
    env.pop("PARFASTAAI_COORDINATOR", None)
    env.update(extra or {})
    return env


def _run_pair(cli_args_for, timeout=240):
    """Run the CLI in 2 coordinated processes; returns their exit codes."""
    port = _free_port()
    procs = []
    for pid in range(2):
        env = _env(
            4,
            {
                "PARFASTAAI_COORDINATOR": f"127.0.0.1:{port}",
                "PARFASTAAI_NUM_PROCESSES": "2",
                "PARFASTAAI_PROCESS_ID": str(pid),
            },
        )
        procs.append(
            subprocess.Popen(
                [sys.executable, "-m", "parfastaai_jax.cli", "--quiet"]
                + cli_args_for(pid),
                env=env,
                cwd=REPO,
            )
        )
    return [p.wait(timeout=timeout) for p in procs]


def _run_single(cli_args, timeout=240):
    return subprocess.run(
        [sys.executable, "-m", "parfastaai_jax.cli", "--quiet"] + cli_args,
        env=_env(8),
        cwd=REPO,
        timeout=timeout,
    ).returncode


@pytest.mark.parametrize(
    "mode_args",
    [
        ["--mesh", "4,2"],
        ["--streamed", "--mesh", "4,2", "--band", "4", "--col-chunk", "5"],
        # Staged-mesh: sharded slab fetches across 2 real processes (the
        # pod-scale capacity path, engine._staged_mesh_block_engine).
        ["--streamed", "--mesh", "4,2", "--staged", "--band", "4",
         "--col-chunk", "5"],
        # Mesh-parallel banded exact: every process joins the count
        # dispatch + gather collectives; only the primary f64-finishes and
        # writes (engine._mesh_count_engine).
        ["--streamed", "--exact", "--mesh", "4,2", "--band", "4",
         "--col-chunk", "5"],
    ],
    ids=["mesh", "streamed_mesh", "staged_mesh", "exact_mesh"],
)
def test_two_process_matches_single(combo12_db, tmp_path, mode_args):
    two = tmp_path / "two.csv"
    other = tmp_path / "nonprimary.csv"

    def args_for(pid):
        # Processes get DIFFERENT output paths: only process 0's may appear.
        out = two if pid == 0 else other
        return [combo12_db, str(out)] + mode_args

    codes = _run_pair(args_for)
    assert codes == [0, 0]
    assert two.exists(), "primary process must write the CSV"
    assert not other.exists(), "non-primary process must not write output"

    one = tmp_path / "one.csv"
    assert _run_single([combo12_db, str(one)] + mode_args) == 0
    assert two.read_bytes() == one.read_bytes()


def test_staged_mesh_meta_only_broadcast(combo12_db, tmp_path):
    """Staged-mesh runs broadcast metadata + T ONLY:
    the non-primary never receives the presence tensor — its PresenceData.m
    is a MetaOnlyM stub that RAISES on any data access, so a 0 exit plus a
    byte-identical CSV proves every slab byte arrived on demand through the
    mesh slab store (engine._mesh_slab_store broadcast branch) and host
    capacity genuinely scales with the pod.  The primary's stdout marker
    proves the meta-only path actually engaged."""
    port = _free_port()
    two = tmp_path / "two.csv"
    mode_args = ["--streamed", "--mesh", "4,2", "--staged", "--band", "4",
                 "--col-chunk", "5"]
    procs = []
    for pid in range(2):
        env = _env(
            4,
            {
                "PARFASTAAI_COORDINATOR": f"127.0.0.1:{port}",
                "PARFASTAAI_NUM_PROCESSES": "2",
                "PARFASTAAI_PROCESS_ID": str(pid),
                # Tiny DB: force past the host-BLAS dispatch so the mesh
                # slab path (the one meta-only serves) actually runs.
                "PARFASTAAI_FORCE_DEVICE": "1",
            },
        )
        out = two if pid == 0 else tmp_path / "np.csv"
        procs.append(
            subprocess.Popen(
                [sys.executable, "-m", "parfastaai_jax.cli",
                 combo12_db, str(out)] + mode_args,
                env=env,
                cwd=REPO,
                stdout=subprocess.PIPE if pid == 0 else None,
                text=pid == 0,
            )
        )
    out0, _ = procs[0].communicate(timeout=240)
    assert procs[1].wait(timeout=240) == 0
    assert procs[0].returncode == 0
    assert "metadata + T only" in out0, out0
    one = tmp_path / "one.csv"
    single = subprocess.run(
        [sys.executable, "-m", "parfastaai_jax.cli", "--quiet",
         combo12_db, str(one)] + mode_args,
        env=_env(8, {"PARFASTAAI_FORCE_DEVICE": "1"}),
        cwd=REPO,
        timeout=240,
    )
    assert single.returncode == 0
    assert two.read_bytes() == one.read_bytes()


def test_two_process_exact_mesh_matches_dense(combo12_db, tmp_path):
    """The 2-process mesh exact CSV equals the single-process DENSE exact
    path byte-for-byte — pod-scale count production changes the throughput,
    never the bytes (reference exactness, algorithm_impl.hpp:222-277)."""
    two = tmp_path / "two.csv"

    def args_for(pid):
        out = two if pid == 0 else tmp_path / "np.csv"
        return [combo12_db, str(out), "--streamed", "--exact",
                "--mesh", "2,4", "--band", "3", "--col-chunk", "3"]

    assert _run_pair(args_for) == [0, 0]
    dense = tmp_path / "dense.csv"
    assert _run_single([combo12_db, str(dense)]) == 0
    assert two.read_bytes() == dense.read_bytes()


def test_nonprimary_never_opens_db(combo12_db, tmp_path):
    """Single-reader ETL: the non-primary process gets a
    NONEXISTENT database path — if it ever tried to open the DB it would
    fail, so success + a byte-identical CSV proves metadata and presence
    arrived via broadcast, not a redundant per-process ETL."""
    mode_args = ["--streamed", "--mesh", "4,2", "--band", "4", "--col-chunk", "5"]
    two = tmp_path / "two.csv"
    other = tmp_path / "nonprimary.csv"
    bogus = str(tmp_path / "does_not_exist.db")

    def args_for(pid):
        db = combo12_db if pid == 0 else bogus
        out = two if pid == 0 else other
        return [db, str(out)] + mode_args

    codes = _run_pair(args_for)
    assert codes == [0, 0]
    assert not other.exists()

    one = tmp_path / "one.csv"
    assert _run_single([combo12_db, str(one)] + mode_args) == 0
    assert two.read_bytes() == one.read_bytes()


def test_primary_db_error_propagates(tmp_path):
    """When the PRIMARY's database is missing, every process must exit with
    the same SQLITE_DB_ERROR code (1) — the error is broadcast in the
    payload's place so non-primaries raise instead of deadlocking in a
    collective the primary never joins."""
    bogus = str(tmp_path / "does_not_exist.db")

    def args_for(pid):
        return [bogus, str(tmp_path / f"out{pid}.csv"), "--mesh", "4,2"]

    codes = _run_pair(args_for, timeout=120)
    assert codes == [1, 1]


def test_primary_corrupt_db_error_propagates(tmp_path):
    """A PRESENT but corrupt database raises a raw sqlite3 error inside the
    primary's ETL — not a PFAAIError.  It must still ride the error
    broadcast (wrapped by cli._as_pfaai_error), or the non-primary
    deadlocks in the presence-broadcast collective."""
    corrupt = tmp_path / "corrupt.db"
    corrupt.write_bytes(b"SQLite format 3\x00" + b"\xde\xad\xbe\xef" * 64)

    def args_for(pid):
        db = str(corrupt) if pid == 0 else str(tmp_path / "none.db")
        return [db, str(tmp_path / f"out{pid}.csv"), "--mesh", "4,2"]

    codes = _run_pair(args_for, timeout=120)
    assert codes[0] != 0 and codes[0] == codes[1]


def test_broadcast_presence_chunked(combo12_db, tmp_path):
    """A tiny PARFASTAAI_BCAST_CHUNK_BYTES forces the presence broadcast
    through many protein-axis chunks; the merged CSV must stay
    byte-identical to a single-process run."""
    port = _free_port()
    procs = []
    two = tmp_path / "two.csv"
    bogus = str(tmp_path / "does_not_exist.db")
    for pid in range(2):
        env = _env(
            4,
            {
                "PARFASTAAI_COORDINATOR": f"127.0.0.1:{port}",
                "PARFASTAAI_NUM_PROCESSES": "2",
                "PARFASTAAI_PROCESS_ID": str(pid),
                "PARFASTAAI_BCAST_CHUNK_BYTES": "64",
            },
        )
        db = combo12_db if pid == 0 else bogus
        out = str(two) if pid == 0 else str(tmp_path / "np.csv")
        procs.append(
            subprocess.Popen(
                [sys.executable, "-m", "parfastaai_jax.cli", "--quiet",
                 db, out, "--mesh", "4,2"],
                env=env,
                cwd=REPO,
            )
        )
    assert [p.wait(timeout=240) for p in procs] == [0, 0]
    one = tmp_path / "one.csv"
    assert _run_single([combo12_db, str(one), "--mesh", "4,2"]) == 0
    assert two.read_bytes() == one.read_bytes()


def test_divergent_dispatch_calibration_cannot_deadlock(
    combo12_db, tmp_path
):
    """The dispatch cost model is auto-calibrated PER PROCESS
    (engine._dispatch_rates), so two processes of one run can disagree on
    _use_host — one taking the collective-free host-BLAS path while the
    other enters the mesh collectives, a deadlock.  compute_streamed
    broadcasts process 0's decision, so even adversarially divergent
    per-process knobs must complete and stay byte-identical to the
    single-process run."""
    port = _free_port()
    two = tmp_path / "two.csv"
    other = tmp_path / "nonprimary.csv"
    mode_args = ["--streamed", "--mesh", "4,2", "--band", "4",
                 "--col-chunk", "5"]
    procs = []
    for pid in range(2):
        env = _env(
            4,
            {
                "PARFASTAAI_COORDINATOR": f"127.0.0.1:{port}",
                "PARFASTAAI_NUM_PROCESSES": "2",
                "PARFASTAAI_PROCESS_ID": str(pid),
                # Process 0 decides HOST; process 1, left to its own
                # limit, would decide DEVICE/mesh.  (HOST_WORK_LIMIT is
                # the first check in _use_host, backend-independent.)
                "PARFASTAAI_HOST_WORK_LIMIT": (
                    "1000000000000000" if pid == 0 else "0"
                ),
            },
        )
        out = two if pid == 0 else other
        procs.append(
            subprocess.Popen(
                [sys.executable, "-m", "parfastaai_jax.cli", "--quiet",
                 combo12_db, str(out)] + mode_args,
                env=env,
                cwd=REPO,
            )
        )
    codes = [p.wait(timeout=240) for p in procs]
    assert codes == [0, 0]
    assert two.exists() and not other.exists()

    one = tmp_path / "one.csv"
    assert (
        _run_single([combo12_db, str(one)] + mode_args) == 0
    )
    assert two.read_bytes() == one.read_bytes()


@pytest.mark.parametrize(
    "mode_args",
    [
        ["--streamed", "--mesh", "4,2", "--band", "4", "--col-chunk", "5"],
        ["--streamed", "--exact", "--mesh", "4,2", "--band", "4",
         "--col-chunk", "5"],
    ],
    ids=["streamed_mesh", "exact_mesh"],
)
def test_primary_worker_fault_aborts_whole_pod(
    combo12_db, tmp_path, mode_args
):
    """A primary-side finish/writer failure mid-run must stop EVERY process:
    werr exists only on the primary, so without the per-band _abort()
    broadcast the non-primaries would keep dispatching into gather
    collectives the primary never joins and hang until the distributed
    timeout.  PARFASTAAI_TEST_WORKER_FAULT injects the failure."""
    port = _free_port()
    procs = []
    for pid in range(2):
        env = _env(
            4,
            {
                "PARFASTAAI_COORDINATOR": f"127.0.0.1:{port}",
                "PARFASTAAI_NUM_PROCESSES": "2",
                "PARFASTAAI_PROCESS_ID": str(pid),
                "PARFASTAAI_TEST_WORKER_FAULT": "1",
            },
        )
        out = tmp_path / f"out{pid}.csv"
        procs.append(
            subprocess.Popen(
                [sys.executable, "-m", "parfastaai_jax.cli", "--quiet",
                 combo12_db, str(out)] + mode_args,
                env=env,
                cwd=REPO,
            )
        )
    # Both processes must EXIT (the hang is the bug); the primary reports
    # the failure, the non-primary stops cleanly.
    codes = [p.wait(timeout=120) for p in procs]
    assert codes[0] != 0, "primary must surface the injected fault"
    assert codes[1] == 0, "non-primary must stop cleanly, not hang"


def test_divergent_mirror_budget_cannot_deadlock(combo12_db, tmp_path):
    """PARFASTAAI_MIRROR_BYTES is read per process and decides which column
    chunks hit the gather collectives (streamed) / the per-band chunk count
    (exact) — divergent values across hosts must not hang: process 0's
    symmetric-mirror decision is broadcast."""
    for mode_args in (
        ["--streamed", "--mesh", "4,2", "--band", "4", "--col-chunk", "5"],
        ["--streamed", "--exact", "--mesh", "4,2", "--band", "4",
         "--col-chunk", "5"],
    ):
        port = _free_port()
        two = tmp_path / "two.csv"
        other = tmp_path / "nonprimary.csv"
        two.unlink(missing_ok=True)
        other.unlink(missing_ok=True)
        procs = []
        for pid in range(2):
            env = _env(
                4,
                {
                    "PARFASTAAI_COORDINATOR": f"127.0.0.1:{port}",
                    "PARFASTAAI_NUM_PROCESSES": "2",
                    "PARFASTAAI_PROCESS_ID": str(pid),
                    # Primary keeps the mirror; the other's budget of 0
                    # would disable it locally.
                    "PARFASTAAI_MIRROR_BYTES": (
                        "4294967296" if pid == 0 else "0"
                    ),
                },
            )
            out = two if pid == 0 else other
            procs.append(
                subprocess.Popen(
                    [sys.executable, "-m", "parfastaai_jax.cli", "--quiet",
                     combo12_db, str(out)] + mode_args,
                    env=env,
                    cwd=REPO,
                )
            )
        codes = [p.wait(timeout=240) for p in procs]
        assert codes == [0, 0], mode_args
        assert two.exists() and not other.exists()

        one = tmp_path / "one.csv"
        one.unlink(missing_ok=True)
        assert _run_single([combo12_db, str(one)] + mode_args) == 0
        assert two.read_bytes() == one.read_bytes(), mode_args
