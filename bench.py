"""Benchmark: fused AJI throughput (genome-pairs/sec/device).

Workload statistics follow the repo's synthetic bench database
(parfastaai_jax/tools/synth_db.py): P=80 proteins, each genome carrying ~400
of a 1200-tetramer per-protein pool (compacted presence width K=1280).

Timing protocol: every timed execution is one jitted ``lax.scan`` chain of
``steps`` block computations.  The presence tensor is salted before the
first step (a per-call counter XORed into it) and each step flips presence
bits from the previous step's result, so no two executions are identical
and no step can be hoisted or elided.  Completion is forced by a 4-byte
scalar download.  The reported time per step is the SLOPE between a short
and a long chain (min over repetitions of each), which cancels the constant
dispatch and download cost.  Prints exactly one JSON line, which names the
device it ran on (platform, device_kind, device count).

Env knobs: PARFASTAAI_BENCH_G (default 4096), PARFASTAAI_BENCH_STEPS
(long-chain length, default 16), PARFASTAAI_BENCH_REPS (repetitions per
chain length).

Modes (PARFASTAAI_BENCH_MODE): unset — the square all-vs-all scan; ``kb``
— the wide-K block (P=16, A=B=1024, K=51200); ``mesh`` — mesh shapes over
the visible devices; ``e2e`` — the wall from a synthetic SQLite database
through ETL, device and CSV, via the real engine entry points.
"""

from __future__ import annotations

import functools
import json
import os
import sys
import tempfile
import time

import numpy as np

# The reference binary's rate on the synthetic bench statistics (BASELINE.md).
BASELINE_PAIRS_PER_SEC = 133.1

# Dense int8 tensor-core peak in MACs/s (1,979 TOP/s / 2 ops per MAC) and
# HBM bandwidth, keyed by jax device_kind.  Source: NVIDIA H100 SXM data
# sheet (rates at the 700 W power limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"int8_macs": 989.5e12, "hbm_bytes": 3.35e12},
}


def _int8_peak(device) -> float | None:
    """The device's int8 MAC/s peak; None on the CPU backend.  An
    accelerator missing from PEAKS is an error, not a default."""
    if device.platform == "cpu":
        return None
    if device.device_kind not in PEAKS:
        raise SystemExit(
            f"bench.py: no int8 peak for device_kind {device.device_kind!r}; "
            "add it to PEAKS with its source"
        )
    return PEAKS[device.device_kind]["int8_macs"]


def _device_fields(jax) -> dict:
    dev = jax.devices()[0]
    return {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": jax.device_count(),
    }


def _chain_slope(jax, jnp, step_fn, operands, s_long, s_short, reps):
    """Seconds per step of ``step_fn(m, *rest) -> (s, n)`` under the salted
    chain protocol (module docstring)."""
    m0, rest = operands[0], operands[1:]
    P, _, K = m0.shape

    @functools.partial(jax.jit, static_argnames="steps")
    def chain(m, salt, *rest, steps):
        m = m ^ (
            ((jnp.arange(m.shape[1]) + salt) % 3 == 0)
            .astype(jnp.int8)[None, :, None]
        )

        def body(m, step):
            s, n = step_fn(m, *rest)
            # Data dependency: XOR genome 0's row of every protein with a
            # mask derived from this step's result.
            drive = n[0, 0].astype(jnp.int32) + step
            fl = (
                (
                    jax.lax.broadcasted_iota(jnp.int32, (P, K), 0)
                    + jax.lax.broadcasted_iota(jnp.int32, (P, K), 1)
                    + drive
                )
                % 2
            ).astype(jnp.int8)
            row0 = (m[:, 0, :] ^ fl)[:, None, :]
            return jax.lax.dynamic_update_slice(m, row0, (0, 0, 0)), s[0, 0]

        _, outs = jax.lax.scan(body, m, jnp.arange(steps, dtype=jnp.int32))
        return outs[-1]

    salt = [0]

    def timed(steps: int) -> float:
        float(chain(m0, jnp.int32(salt[0]), *rest, steps=steps))  # compile
        best = float("inf")
        for _ in range(reps):
            salt[0] += 1
            t0 = time.perf_counter()
            float(chain(m0, jnp.int32(salt[0]), *rest, steps=steps))
            best = min(best, time.perf_counter() - t0)
        return best

    return (timed(s_long) - timed(s_short)) / (s_long - s_short)


def _chain_lengths(default_long: int) -> tuple[int, int]:
    s_long = max(2, int(os.environ.get("PARFASTAAI_BENCH_STEPS", default_long)))
    s_short = max(1, s_long // 8 if s_long >= 8 else s_long // 2)
    return s_long, s_short


def _synth(P: int, G: int, K: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    m = (rng.random((P, G, K)) < (400 / 1280)).astype(np.int8)
    return m, m.sum(axis=2, dtype=np.int32)


def main() -> None:
    import jax
    import jax.numpy as jnp

    from parfastaai_jax.engine import upload_presence
    from parfastaai_jax.ops.fused import fused_sn
    from parfastaai_jax.utils.jitcache import enable_compilation_cache

    enable_compilation_cache()
    g = int(os.environ.get("PARFASTAAI_BENCH_G", "4096"))
    s_long, s_short = _chain_lengths(16)
    reps = int(os.environ.get("PARFASTAAI_BENCH_REPS", "5"))
    P, K = 80, 1280  # pool padded 1200 -> 1280 (constants.LANE multiple)
    m, t = _synth(P, g, K)
    per_iter = _chain_slope(
        jax, jnp, fused_sn, (upload_presence(m), jnp.asarray(t)),
        s_long, s_short, reps,
    )
    pairs = g * (g - 1) // 2
    pairs_per_sec = pairs / per_iter
    # The square scan computes every cell (no triangle skip): these are the
    # MACs the device issues.
    mac_per_s = P * g * g * K / per_iter
    peak = _int8_peak(jax.devices()[0])
    print(
        json.dumps(
            {
                "metric": "genome-pairs/sec/device (fused S/N square, G=%d "
                "P=%d K=%d)" % (g, P, K),
                "value": round(pairs_per_sec, 1),
                "unit": "pairs/s",
                "vs_baseline": round(pairs_per_sec / BASELINE_PAIRS_PER_SEC, 1),
                "int8_mac_per_s": round(mac_per_s, 1),
                "mfu": round(mac_per_s / peak, 4) if peak else None,
                **_device_fields(jax),
            }
        )
    )


def main_kb() -> None:
    """Wide-K block bench (PARFASTAAI_BENCH_MODE=kb): one (A, B) block at a
    contraction width 40x the headline bench's, the shape class of the
    staged engines' wide width buckets — P=16, A=B=1024, K=51200.  Same
    chain protocol as main()."""
    import jax
    import jax.numpy as jnp

    from parfastaai_jax.engine import upload_presence
    from parfastaai_jax.ops.fused import fused_sn_block
    from parfastaai_jax.utils.jitcache import enable_compilation_cache

    enable_compilation_cache()
    P, A, B, K = 16, 1024, 1024, 51200
    s_long, s_short = _chain_lengths(4)
    reps = int(os.environ.get("PARFASTAAI_BENCH_REPS", "3"))
    ma, ta = _synth(P, A, K, seed=0)
    mb, tb = _synth(P, B, K, seed=1)
    per_iter = _chain_slope(
        jax, jnp, fused_sn_block,
        (upload_presence(ma), upload_presence(mb), jnp.asarray(ta),
         jnp.asarray(tb)),
        s_long, s_short, reps,
    )
    mac_per_s = P * A * B * K / per_iter
    peak = _int8_peak(jax.devices()[0])
    print(
        json.dumps(
            {
                "metric": "genome-pairs/sec/device (wide-K S/N block, P=%d "
                "A=%d B=%d K=%d)" % (P, A, B, K),
                "value": round(A * B / per_iter, 1),
                "unit": "pairs/s",
                "vs_baseline": round(
                    A * B / per_iter / BASELINE_PAIRS_PER_SEC, 1
                ),
                "int8_mac_per_s": round(mac_per_s, 1),
                "mfu": round(mac_per_s / peak, 4) if peak else None,
                **_device_fields(jax),
            }
        )
    )


def main_mesh() -> None:
    """Mesh-scaling bench (PARFASTAAI_BENCH_MODE=mesh): sweep mesh shapes
    over the visible devices and emit pairs/s per device and scaling
    efficiency per shape — the harness for BASELINE.json's ">=0.8 scaling
    efficiency" target.

    Per shape, the timed program is the production mesh step
    (parallel.mesh._body under shard_map: per-device row band x full column
    side, psum over scp), driven by the same chain protocol as main().  A
    'direct' leg times the single-device square scan with no mesh wrapper,
    which the (1, 1) shape must reproduce within noise.  Efficiency is the
    per-device rate relative to the (1, 1) mesh."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as Spec

    from parfastaai_jax.engine import upload_presence, upload_presence_sharded
    from parfastaai_jax.ops.fused import fused_sn
    from parfastaai_jax.parallel.mesh import _body, make_mesh
    from parfastaai_jax.utils.jitcache import enable_compilation_cache

    enable_compilation_cache()
    g = int(os.environ.get("PARFASTAAI_BENCH_G", "4096"))
    s_long, s_short = _chain_lengths(16)
    reps = int(os.environ.get("PARFASTAAI_BENCH_REPS", "5"))
    P, K = 80, 1280
    m, t = _synth(P, g, K)

    ndev = jax.device_count()
    shapes = []
    n = 1
    while n <= ndev and g % n == 0:
        shapes.append((n, 1))
        n *= 2
    if ndev >= 4 and g % (ndev // 2) == 0 and P % 2 == 0:
        shapes.append((ndev // 2, 2))

    def slope(step_fn, md, td):
        return _chain_slope(
            jax, jnp, step_fn, (md, td), s_long, s_short, reps
        )

    # The mesh path computes the full G x G square by design; rates are in
    # unordered genome pairs (g*(g-1)/2 per step) like the kernel bench.
    pairs = g * (g - 1) // 2
    direct_rate = pairs / slope(
        fused_sn, upload_presence(m), jnp.asarray(t)
    )

    results = []
    base_per_dev = None
    for n_rows, n_scp in shapes:
        mesh = make_mesh(n_rows, n_scp)
        fn = shard_map(
            functools.partial(_body, band=g // n_rows, want_aji=False),
            mesh=mesh,
            in_specs=(Spec("scp", None, None), Spec("scp", None)),
            out_specs=(Spec("rows", None), Spec("rows", None)),
        )
        md = upload_presence_sharded(
            m, NamedSharding(mesh, Spec("scp", None, None))
        )
        td = jax.device_put(t, NamedSharding(mesh, Spec("scp", None)))
        rate = pairs / slope(fn, md, td)
        ndev_shape = n_rows * n_scp
        per_dev = rate / ndev_shape
        if base_per_dev is None:
            base_per_dev = per_dev
        results.append(
            {
                "mesh": f"{n_rows}x{n_scp}",
                "chips": ndev_shape,
                "pairs_per_sec": round(rate, 1),
                "pairs_per_sec_per_chip": round(per_dev, 1),
                "efficiency_vs_1chip": round(per_dev / base_per_dev, 4),
            }
        )
        del md, td

    best = max(results, key=lambda r: r["pairs_per_sec"])
    print(
        json.dumps(
            {
                "metric": "mesh scaling: genome-pairs/s via the full-square "
                "fused S/N mesh step (G=%d P=%d K=%d)" % (g, P, K),
                "value": best["pairs_per_sec"],
                "unit": "pairs/s",
                "vs_baseline": round(
                    best["pairs_per_sec"] / BASELINE_PAIRS_PER_SEC, 1
                ),
                "direct_pairs_per_sec": round(direct_rate, 1),
                "mesh_vs_direct_1chip": round(
                    results[0]["pairs_per_sec"] / direct_rate, 4
                ),
                "shapes": results,
                **_device_fields(jax),
            }
        )
    )


def main_e2e() -> None:
    """End-to-end pipeline wall: SQLite DB -> ETL -> device -> CSV.

    Baseline comparison: the reference rate (133.1 pairs/s, BASELINE.md)
    extrapolated to this pair count — charitable to the reference, whose
    per-pair cost grows with G (E sort).
    """
    import jax

    from parfastaai_jax.utils.jitcache import enable_compilation_cache

    enable_compilation_cache()
    tmp = tempfile.gettempdir()
    g = int(os.environ.get("PARFASTAAI_BENCH_G", "4096"))
    path = os.environ.get(
        "PARFASTAAI_BENCH_DB", os.path.join(tmp, f"pfaai_bench_synth{g}.db")
    )
    if not os.path.exists(path):
        from parfastaai_jax.tools.synth_db import generate

        t0 = time.perf_counter()
        generate(path, n_genomes=g, n_proteins=80, pool_size=1200,
                 tetras_per_genome=400, seed=0)
        print(
            f"# generated {path} in {time.perf_counter() - t0:.1f}s "
            "(one-time, not part of the e2e wall)",
            file=sys.stderr,
        )

    from parfastaai_jax.engine import compute_fast, compute_streamed
    from parfastaai_jax.etl.database import SCPDatabase
    from parfastaai_jax.io.csv_writer import write_aji_csv
    from parfastaai_jax.modes import all_vs_all

    def out(name: str) -> str:
        return os.path.join(tmp, f"pfaai_bench_e2e_{g}{name}.csv")

    phases: dict[str, float] = {}

    def timed(name: str, fn):
        t0 = time.perf_counter()
        res = fn()
        phases[name] = round(time.perf_counter() - t0, 2)
        return res

    streamed_only = bool(os.environ.get("PARFASTAAI_BENCH_STREAMED_ONLY"))
    t_total = time.perf_counter()
    db = timed("db_open", lambda: SCPDatabase(path))
    pairs = all_vs_all(db.meta)
    presence = timed("etl", db.load_presence)
    db.close()
    os.environ.setdefault("PARFASTAAI_FORCE_DEVICE", "1")
    if streamed_only:
        fused_wall = float("nan")
    else:
        result = timed("fused_aji", lambda: compute_fast(presence, pairs))
        timed(
            "csv",
            lambda: write_aji_csv(out(""), pairs, result.aji, ","),
        )
        fused_wall = time.perf_counter() - t_total

    # Streamed path (same DB, CSV written band by band).
    t0 = time.perf_counter()
    compute_streamed(
        presence,
        pairs.row_db_ids,
        pairs.col_db_ids,
        out("_streamed"),
        pairs.query_names,
        pairs.target_names,
    )
    phases["streamed_aji_csv"] = round(time.perf_counter() - t0, 2)
    streamed_wall = phases["db_open"] + phases["etl"] + phases["streamed_aji_csv"]

    # Banded exact path (PARFASTAAI_BENCH_EXACT=1): bit-parity f64 CSV.
    exact_wall = None
    # EXACT_MESH implies the direct exact leg (its CSV is the mesh leg's
    # comparison baseline), so setting only the mesh knob still runs both.
    if os.environ.get("PARFASTAAI_BENCH_EXACT") or os.environ.get(
        "PARFASTAAI_BENCH_EXACT_MESH"
    ):
        from parfastaai_jax.engine import compute_streamed_exact

        t0 = time.perf_counter()
        compute_streamed_exact(
            presence,
            pairs.row_db_ids,
            pairs.col_db_ids,
            out("_exact"),
            pairs.query_names,
            pairs.target_names,
        )
        phases["banded_exact_csv"] = round(time.perf_counter() - t0, 2)
        exact_wall = (
            phases["db_open"] + phases["etl"] + phases["banded_exact_csv"]
        )

        # Mesh-sanity leg (PARFASTAAI_BENCH_EXACT_MESH="rows,scp"): the same
        # banded exact run through the sharded count engine; its CSV must be
        # byte-identical to the direct leg's.
        mesh_spec = os.environ.get("PARFASTAAI_BENCH_EXACT_MESH")
        if mesh_spec:
            import filecmp

            from parfastaai_jax.parallel.mesh import make_mesh

            rows_n, scp_n = (int(x) for x in mesh_spec.split(","))
            t0 = time.perf_counter()
            compute_streamed_exact(
                presence,
                pairs.row_db_ids,
                pairs.col_db_ids,
                out("_exact_mesh"),
                pairs.query_names,
                pairs.target_names,
                mesh=make_mesh(rows_n, scp_n),
            )
            phases["banded_exact_mesh_csv"] = round(
                time.perf_counter() - t0, 2
            )
            if not filecmp.cmp(out("_exact"), out("_exact_mesh"),
                               shallow=False):
                raise AssertionError(
                    "mesh exact CSV differs from direct exact CSV"
                )
            phases["banded_exact_mesh_bytes_identical"] = True

    n_pairs = g * (g - 1) // 2
    ref_seconds = n_pairs / BASELINE_PAIRS_PER_SEC
    main_wall = streamed_wall if streamed_only else fused_wall
    P_, G_, K_ = presence.m.shape
    # Bytes each path moves between host and device: packed presence
    # upload, the streamed f32 AJI blocks with the below-diagonal mirror
    # skipped (~half of G^2), the exact triangle's int16 count blocks.
    wire = {
        "upload_packed_presence_bytes": P_ * G_ * K_ // 8,
        "streamed_download_bytes": 4 * (G_ * G_ // 2),
        "exact_download_bytes": 2 * P_ * (G_ * G_ // 2),
    }
    rec = {
        "metric": "e2e wall: SQLite->ETL->device->CSV "
        "(synth G=%d P=80, %d pairs, %s path)"
        % (g, n_pairs, "streamed" if streamed_only else "fused"),
        "value": round(main_wall, 2),
        "unit": "s",
        "vs_baseline": round(ref_seconds / main_wall, 1),
        "phases": phases,
        "streamed_wall_seconds": round(streamed_wall, 2),
        "reference_extrapolated_seconds": round(ref_seconds),
        "wire_bytes": wire,
        **_device_fields(jax),
    }
    if exact_wall is not None:
        rec["exact_wall_seconds"] = round(exact_wall, 2)
    print(json.dumps(rec))


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    mode = os.environ.get("PARFASTAAI_BENCH_MODE")
    if mode == "e2e":
        main_e2e()
    elif mode == "mesh":
        main_mesh()
    elif mode == "kb":
        main_kb()
    else:
        main()
