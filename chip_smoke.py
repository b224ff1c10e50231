"""Smoke run of the AJI engine on an NVIDIA GPU at real size.

    python chip_smoke.py               # one card
    python chip_smoke.py --four-cards  # the mesh paths on four cards

One process drives everything: it builds a seeded synthetic database at
the repo's bench statistics (G=4096 genomes, P=80 SCPs, a 1,200-tetramer
pool per protein, 400 tetramers per genome), runs every CLI mode in-process
through ``parfastaai_jax.cli.run``, checks the CSVs against each other and
against a plain f64 oracle (tests/oracle.py), times the fused block step
at two shapes, and prints one JSON line last.  Any failed phase raises, so
the exit code is non-zero and no JSON line is printed.  It refuses to run
without a GPU.

Tolerances: the exact paths are byte-identical to each other and within
1 ulp of the oracle (integer counts, f64 finish in the reference's order).
Every f32 path is within 5e-6 of the exact AJI: P * 2^-24 for P=80 terms
each at most 1, summed in another order than on the host, with XLA's f32
divide (phase 5 measures how far it is from IEEE).
"""

from __future__ import annotations

import argparse
import contextlib
import filecmp
import gc
import json
import os
import shutil
import subprocess
import sys
import time
from unittest import mock

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GENOMES = 4096
F32_TOL = 5e-6


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    log(f"== {name}")
    yield
    log(f"== {name}: {time.perf_counter() - t0:.2f} s")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def require_gpus(jax, need: int) -> None:
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs a GPU, JAX found {devs[0].platform!r}"
        )
    if len(devs) < need:
        raise SystemExit(f"chip_smoke: needs {need} GPUs, found {len(devs)}")


def device_check(jax) -> None:
    from parfastaai_jax.engine import _hbm_budget

    devs = jax.devices()
    limit = devs[0].memory_stats()["bytes_limit"]
    log(f"device_kind {devs[0].device_kind!r}, {len(devs)} device(s), "
        f"bytes_limit {limit}, engine budget {_hbm_budget()}")
    log(f"nvidia-smi: {card_line()}")


def make_data(work: str, genomes: int) -> dict:
    import sqlite3

    from parfastaai_jax.tools.subset_db import build_subset_db
    from parfastaai_jax.tools.synth_db import generate

    paths = {k: os.path.join(work, f"{k}.db") for k in ("all", "query", "target")}
    t0 = time.perf_counter()
    generate(paths["all"], n_genomes=genomes, n_proteins=80, pool_size=1200,
             tetras_per_genome=400, seed=0)
    log(f"generated {genomes}-genome DB ({os.path.getsize(paths['all'])} B) "
        f"in {time.perf_counter() - t0:.2f} s")
    conn = sqlite3.connect(paths["all"])
    names = [r[0] for r in conn.execute("SELECT genome_name FROM genome_metadata")]
    conn.close()
    queries = names[::16]
    qset = set(queries)
    build_subset_db(paths["all"], paths["query"], queries)
    build_subset_db(paths["all"], paths["target"],
                    [n for n in names if n not in qset])
    paths["qlist"] = os.path.join(work, "queries.txt")
    with open(paths["qlist"], "w") as fp:
        fp.write("\n".join(queries) + "\n")
    paths["names"] = names
    log(f"query DB {len(queries)} genomes, target DB "
        f"{len(names) - len(queries)} genomes, query list {len(queries)} names")
    return paths


def cli(work: str, name: str, argv: list[str], env: dict | None = None) -> str:
    """One in-process CLI run; returns the CSV path."""
    from parfastaai_jax.cli import run

    out = os.path.join(work, f"{name}.csv")
    with mock.patch.dict(os.environ, env or {}):
        t0 = time.perf_counter()
        rc = run([argv[0], out, "--quiet", *argv[1:]])
        wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"CLI {name} {argv} exited {rc}")
    gc.collect()
    flags = " ".join(os.path.basename(a) for a in argv[1:]) or "(default)"
    log(f"cli {name:<24} {flags:<28} {wall:8.2f} s  {os.path.getsize(out)} B")
    return out


def csv_rows(path: str):
    with open(path, "rb") as fp:
        header = fp.readline().rstrip(b"\n").split(b",")[1:]
        yield header
        for line in fp:
            name, _, vals = line.rstrip(b"\n").partition(b",")
            yield name, np.fromiter(
                map(float, vals.split(b",")), np.float64, len(header)
            )


def max_f32_diff(f32_csv: str, exact_csv: str) -> float:
    """max |AJI_f32 - AJI_exact| over every cell; nan cells of the exact CSV
    (no shared protein) must be nan or 0 in the f32 one."""
    a, b = csv_rows(f32_csv), csv_rows(exact_csv)
    if next(a) != next(b):
        raise AssertionError(f"{f32_csv}: header differs")
    worst = 0.0
    for (na, va), (nb, vb) in zip(a, b, strict=True):
        if na != nb:
            raise AssertionError(f"{f32_csv}: row {na!r} vs {nb!r}")
        nan = np.isnan(vb)
        if not np.all(np.isnan(va[nan]) | (va[nan] == 0)):
            raise AssertionError(f"{f32_csv}: row {na!r} nan cells differ")
        if np.isnan(va[~nan]).any():
            raise AssertionError(f"{f32_csv}: row {na!r} has extra nan")
        worst = max(worst, float(np.abs(va[~nan] - vb[~nan]).max(initial=0)))
    return worst


def check_f32(label: str, f32_csv: str, exact_csv: str) -> None:
    d = max_f32_diff(f32_csv, exact_csv)
    log(f"check {label}: max |dAJI| {d:.3e} (bound {F32_TOL:.0e})")
    if not d <= F32_TOL:
        raise AssertionError(f"{label}: max |dAJI| {d} > {F32_TOL}")


def check_identical(label: str, a: str, b: str) -> None:
    same = filecmp.cmp(a, b, shallow=False)
    log(f"check {label}: byte-identical {same}")
    if not same:
        raise AssertionError(f"{label}: CSVs differ")


def check_oracle(db: str, exact_csv: str, n_rows: int = 64) -> None:
    """Sampled rows of the exact CSV against the plain f64 oracle."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from oracle import aji_matrix

    rows = csv_rows(exact_csv)
    header = [h.decode() for h in next(rows)]
    pick = set(np.linspace(0, len(header) - 1, n_rows).astype(int).tolist())
    got, names = [], []
    for i, (name, vals) in enumerate(rows):
        if i in pick:
            names.append(name.decode())
            got.append(vals)
    got = np.array(got)
    t0 = time.perf_counter()
    want = aji_matrix(db, names, header)
    want[np.array(names)[:, None] == np.array(header)[None, :]] = 0.0
    nan = np.isnan(want)
    if not np.array_equal(nan, np.isnan(got)):
        raise AssertionError("oracle: nan cells differ")
    ulps = np.abs(got[~nan] - want[~nan]) / np.spacing(np.abs(want[~nan]))
    worst = float(ulps.max(initial=0))
    log(f"check exact vs f64 oracle: {len(names)} rows x {len(header)} cols, "
        f"max {worst:.1f} ulp, max |d| "
        f"{float(np.abs(got[~nan] - want[~nan]).max(initial=0)):.3e} "
        f"(oracle {time.perf_counter() - t0:.2f} s)")
    if worst > 1:
        raise AssertionError(f"oracle: {worst} ulp > 1")


def median_time(jax, fn, *args, n: int = 5) -> float:
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def block_operands(jax, P: int, A: int, B: int, K: int, seed: int):
    jnp = jax.numpy
    ka, kb = jax.random.split(jax.random.key(seed))
    ma = (jax.random.uniform(ka, (P, A, K)) < 400 / 1280).astype(jnp.int8)
    mb = (jax.random.uniform(kb, (P, B, K)) < 400 / 1280).astype(jnp.int8)
    return ma, mb, ma.sum(2, dtype=jnp.int32), mb.sum(2, dtype=jnp.int32)


def compile_check(jax) -> None:
    """Lower and compile the band step the fused and streamed paths run, at
    real widths; print what XLA reserves for it."""
    from parfastaai_jax.ops.fused import fused_sn_block

    jnp = jax.numpy
    P, A, B, K = 80, 512, 4096, 1280
    args = (
        jax.ShapeDtypeStruct((P, A, K), jnp.int8),
        jax.ShapeDtypeStruct((P, B, K), jnp.int8),
        jax.ShapeDtypeStruct((P, A), jnp.int32),
        jax.ShapeDtypeStruct((P, B), jnp.int32),
    )
    t0 = time.perf_counter()
    compiled = fused_sn_block.lower(*args).compile()
    log(f"band step P={P} A={A} B={B} K={K}: compiled in "
        f"{time.perf_counter() - t0:.2f} s; {compiled.memory_analysis()}")


def divide_check(jax) -> None:
    """How the f32 Jaccard term the device paths compute compares with the
    IEEE divide (numpy on the host), over the terms' integer operands."""
    from parfastaai_jax.ops.fused import _jaccard

    rng = np.random.default_rng(0)
    cnt = rng.integers(1, 1500, 1 << 20).astype(np.int32)
    den = cnt + rng.integers(0, 1500, 1 << 20).astype(np.int32)
    want = cnt.astype(np.float32) / den.astype(np.float32)
    got = np.asarray(jax.jit(_jaccard)(cnt, den))
    ulp = np.abs(got - want) / np.spacing(want)
    log(f"divide: {int((got != want).sum())} of {cnt.size} Jaccard terms "
        f"differ from the IEEE quotient, max {float(ulp.max()):.1f} ulp")


def block_timing(jax) -> None:
    """Device time of the fused block (median of 5, warm,
    block_until_ready) at the band shape and the wide-K shape."""
    from bench import PEAKS
    from parfastaai_jax.ops.fused import fused_sn_block

    peak = PEAKS.get(jax.devices()[0].device_kind, {}).get("int8_macs")
    for label, (P, A, B, K) in (
        ("band", (80, 512, 4096, 1280)),
        ("wide-K", (16, 1024, 1024, 51200)),
    ):
        ops = block_operands(jax, P, A, B, K, seed=1)
        t = median_time(jax, fused_sn_block, *ops)
        macs = P * A * B * K
        share = f", {macs / t / peak:.4f} of int8 peak" if peak else ""
        log(f"block {label} P={P} A={A} B={B} K={K}: {t * 1e3:.4f} ms, "
            f"{macs / t / 1e12:.2f} TMAC/s{share}")
        del ops
        gc.collect()


def one_card(work: str, genomes: int) -> None:
    import jax

    import parfastaai_jax.engine as engine

    with phase("phase 1: data"):
        d = make_data(work, genomes)
    with phase("phase 2: compile check"):
        compile_check(jax)

    # Every run below must reach the device: record each host/device choice.
    choices = []
    real_use_host = engine._use_host

    def spy(presence):
        choices.append(real_use_host(presence))
        return choices[-1]

    db, qdb, tdb = d["all"], d["query"], d["target"]
    with phase("phase 3: CLI runs"), mock.patch.object(engine, "_use_host", spy):
        # The default exact path auto-routes to the banded engine above a
        # 4 GiB host footprint; a larger budget keeps the dense device path.
        exact = cli(work, "exact", [db],
                    env={"PARFASTAAI_EXACT_HOST_BYTES": str(64 << 30)})
        s_exact = cli(work, "streamed_exact", [db, "--streamed", "--exact"])
        fast = cli(work, "fast", [db, "--fast"])
        streamed = cli(work, "streamed", [db, "--streamed"])
        staged = cli(work, "staged", [db, "--streamed", "--staged"])
        qt_exact = cli(work, "qt_exact", [tdb, "-r", qdb])
        qt_fast = cli(work, "qt_fast", [tdb, "-r", qdb, "--fast"])
        qs_exact = cli(work, "qsub_exact", [db, "-q", d["qlist"]])
        qs_streamed = cli(work, "qsub_streamed",
                          [db, "-q", d["qlist"], "--streamed"])
    with phase("phase 4: comparisons"):
        check_identical("--streamed --exact vs default exact", s_exact, exact)
        check_oracle(db, exact)
        for label, f32, ref in (
            ("--fast", fast, exact),
            ("--streamed", streamed, exact),
            ("--streamed --staged", staged, exact),
            ("-r --fast", qt_fast, qt_exact),
            ("-q --streamed", qs_streamed, qs_exact),
        ):
            check_f32(label, f32, ref)
        macs = 80 * genomes * genomes * 1280
        log(f"dispatch: {len(choices)} host/device choices, host taken "
            f"{sum(choices)}; {macs:.3e} MACs vs HOST_WORK_LIMIT "
            f"{engine.HOST_WORK_LIMIT:.1e}")
        if any(choices) or not choices:
            raise AssertionError("a run took the host-BLAS path")
        peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
        log(f"device peak_bytes_in_use {peak}")
        for f in (exact, s_exact, fast, streamed, staged):
            os.remove(f)
    with phase("phase 5: block timing"):
        divide_check(jax)
        block_timing(jax)


def four_cards(work: str, genomes: int) -> None:
    with phase("phase 1: data"):
        d = make_data(work, genomes)
    db = d["all"]
    with phase("phase 3: CLI runs (one card, then meshes over four)"):
        streamed = cli(work, "streamed_1card", [db, "--streamed"])
        exact = cli(work, "streamed_exact_1card", [db, "--streamed", "--exact"])
        mesh = cli(work, "mesh_4x1", [db, "--mesh", "4,1"])
        s_mesh = cli(work, "streamed_mesh_2x2", [db, "--streamed", "--mesh", "2,2"])
        x_mesh = cli(work, "streamed_exact_mesh_4x1",
                     [db, "--streamed", "--exact", "--mesh", "4,1"])
    with phase("phase 4: comparisons"):
        check_f32("--mesh 4,1 vs one-card --streamed", mesh, streamed)
        check_f32("--streamed --mesh 2,2 vs one-card --streamed", s_mesh,
                  streamed)
        check_identical("--streamed --exact --mesh 4,1 vs one-card exact",
                        x_mesh, exact)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the mesh paths (and their one-card "
                    "references) on four GPUs")
    args = ap.parse_args()
    sys.path.insert(0, HERE)

    import jax

    from parfastaai_jax.utils.jitcache import enable_compilation_cache

    require_gpus(jax, 4 if args.four_cards else 1)
    with phase("phase 0: device check"):
        device_check(jax)
    enable_compilation_cache()
    work = os.path.join(HERE, ".smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        (four_cards if args.four_cards else one_card)(work, GENOMES)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    dev = jax.devices()[0]
    log(f"nvidia-smi: {card_line()}")
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
    }), flush=True)


if __name__ == "__main__":
    main()
