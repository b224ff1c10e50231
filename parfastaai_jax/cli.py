"""Command-line driver mirroring the reference CLI (src/main.cpp:56-131,
337-356).

Positionals: path_to_input_db, path_to_output_file.
Options: -r/--query_db (two-database mode), -q/--query_subset (query-subset
mode), -s/--separator.  Mode dispatch matches main.cpp:337-356: -q wins over
plain all-vs-all; -r with a *different* db selects two-database mode (-r with
the same db degenerates to all-vs-all, as in the reference).
"""

from __future__ import annotations

import argparse
import os
import sys

from . import __version__
from .engine import (
    compute,
    compute_fast,
    compute_sharded,
    compute_streamed,
    compute_streamed_exact,
)
from .etl.database import QueryTargetDatabase, SCPDatabase
from .io.csv_writer import write_aji_csv
from .modes import (
    all_vs_all,
    all_vs_all_axes,
    query_subset,
    query_subset_axes,
    query_target,
    query_target_axes,
)
from .types import ErrorCode, PFAAIError
from .utils.timing import phase_timer


def _as_pfaai_error(e: Exception) -> PFAAIError:
    """Wrap any primary-side failure so it can ride the error broadcast
    (picklable, uniform exit code) instead of stranding the other processes
    in a collective the primary never joins."""
    if isinstance(e, PFAAIError):
        return e
    code = (
        ErrorCode.SQLITE_MEM_ALLOC_ERROR
        if isinstance(e, MemoryError)
        else ErrorCode.SQLITE_DB_ERROR
    )
    return PFAAIError(code, f"{type(e).__name__}: {e}")


def _exact_host_budget() -> int:
    """Host-memory budget gating the default exact path's dense machinery
    (PARFASTAAI_EXACT_HOST_BYTES overrides; default 4 GiB)."""
    env = os.environ.get("PARFASTAAI_EXACT_HOST_BYTES")
    return int(float(env)) if env else 4 << 30


def _route_banded_exact(n_pairs_est: int, n_proteins: int) -> bool:
    """True when the default exact path should route through the banded
    exact engine: its dense form materializes the (P, n_pairs) count matrix
    plus two (P, n_pairs) int32 denominator gathers on host — ~41 GB at
    G=8192 all-vs-all — where the banded engine produces the identical CSV
    bytes in O(P * band * col_chunk) memory (the reference is exact at any
    size it can hold, algorithm_impl.hpp:222-277).
    The estimate uses the int16 count dtype (the common case) — routing is a
    performance decision, not a semantic one."""
    bytes_est = n_pairs_est * n_proteins * (2 + 2 * 4)
    return bytes_est > _exact_host_budget()


def load_query_genomes(path: str) -> list[str]:
    """Whitespace-split genome names (reference AppParams::load_query_genomes,
    src/main.cpp:114-124)."""
    with open(path) as fp:
        return fp.read().split()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="parfastaai-jax",
        description="Accelerator Average Jaccard Index (AJI) engine",
    )
    p.add_argument("path_to_input_db", help="Path to the main/target SQLite database")
    p.add_argument("path_to_output_file", help="Path to the output CSV")
    p.add_argument(
        "-r", "--query_db", default="", help="Query database (two-database mode)"
    )
    p.add_argument(
        "-q",
        "--query_subset",
        default="",
        help="File listing query genome names (query-subset mode)",
    )
    p.add_argument("-s", "--separator", default=",", help="Output field separator")
    p.add_argument(
        "--no-compat-qt-t-swap",
        action="store_true",
        help=(
            "Disable replication of the reference's swapped T-column read in "
            "two-database mode (see modes.query_target); changes two-database "
            "results away from reference parity"
        ),
    )
    p.add_argument(
        "--fast",
        action="store_true",
        help=(
            "Fused on-device f32 pipeline (production screening): ~1e-7 "
            "relative error vs the default exact/bit-parity path, far less "
            "host traffic"
        ),
    )
    p.add_argument(
        "--streamed",
        action="store_true",
        help=(
            "Streaming row-band engine: write the CSV incrementally with "
            "O(band x G) memory (f32 device pipeline; for genome counts "
            "where the full pair list / result matrix does not fit)"
        ),
    )
    p.add_argument(
        "--exact",
        action="store_true",
        help=(
            "With --streamed: banded EXACT engine — bit-parity f64 AJI "
            "(identical bytes to the default exact path's CSV) written in "
            "row bands with O(band x col-chunk) memory at any genome count; "
            "integer counts ship per block instead of the full (P, n_pairs) "
            "matrix"
        ),
    )
    p.add_argument(
        "--staged",
        action="store_true",
        help=(
            "Force presence-slab staging: genome slabs are uploaded on "
            "demand (LRU-cached) instead of holding the whole presence "
            "tensor in device memory — for databases larger than one "
            "device's memory.  Default: automatic when the backend reports a "
            "memory limit the presence tensor exceeds "
            "(PARFASTAAI_HBM_BYTES overrides the budget)"
        ),
    )
    p.add_argument(
        "--band", type=int, default=1024, help="Streamed mode: rows per band"
    )
    p.add_argument(
        "--col-chunk",
        type=int,
        default=4096,
        help="Streamed mode: columns per device block",
    )
    p.add_argument(
        "--resume",
        action="store_true",
        help=(
            "Streamed mode: continue an interrupted run — complete "
            "band-aligned rows already in the output file are kept"
        ),
    )
    p.add_argument(
        "--mesh",
        default="",
        metavar="ROWS[,SCP]",
        help=(
            "Run the fused pipeline over a device mesh: ROWS-way genome-band "
            "data parallelism x SCP-way protein sharding (default: single "
            "device)"
        ),
    )
    p.add_argument(
        "--profile",
        default="",
        metavar="DIR",
        help=(
            "Capture a JAX profiler trace of the compute phase into DIR "
            "(view with TensorBoard / xprof)"
        ),
    )
    p.add_argument(
        "--dump-jac",
        default="",
        metavar="PATH",
        help=(
            "Also write the per-pair JAC tuples (genomeA, genomeB, S, N, AJI) "
            "as CSV — the reference's debug print_aji/getJAC surface "
            "(algorithm_impl.hpp:331-356)"
        ),
    )
    p.add_argument(
        "--dump-e",
        default="",
        metavar="PATH",
        help=(
            "Also write the sorted E array (proteinIndex, genomeA, genomeB) "
            "as CSV — the reference's debug print_e surface "
            "(algorithm_impl.hpp:331-343), re-derived host-side with each "
            "mode's isValidPair semantics (E is a parity artifact, never "
            "materialized on the production path)"
        ),
    )
    p.add_argument("--quiet", action="store_true", help="Suppress phase timing output")
    p.add_argument("--version", action="version", version=__version__)
    return p


def _print_args_box(args) -> None:
    """Run-configuration box, mirroring the reference's AppParams::print
    (src/main.cpp:90-112: same five rows, same box drawing)."""
    rows = [
        f" Input Database  : {args.path_to_input_db} ",
        f" Query Database  : {args.query_db} ",
        f" Query Subset    : {args.query_subset} ",
        f" Output File     : {args.path_to_output_file} ",
        f" Field Separator : {args.separator} ",
    ]
    w = max(len(r) for r in rows)
    print(" ┌" + "─" * w + "┐")
    for r in rows:
        print(" │" + r.ljust(w) + "│")
    print(" └" + "─" * w + "┘")


def _init_backend() -> bool:
    """Backend bootstrap, called before ANY JAX backend touch.

    Order matters: ``jax.distributed.initialize`` must run before the local
    backend initializes, or a multi-host launch silently degenerates to N
    independent single-process runs (each would write the CSV).

    Returns True when running multi-process.
    """
    from .parallel.distributed import init_distributed

    return init_distributed()


def _enable_compilation_cache() -> None:
    from .utils.jitcache import enable_compilation_cache

    enable_compilation_cache()


def _banded_exact_run(args, presence, pairs, verbose, resume, mesh=None):
    """Shared banded-exact driver: --streamed --exact and the auto-routed
    default exact path run the identical engine call (bit-parity f64 CSV in
    bounded memory, engine.compute_streamed_exact).  ``mesh`` shards the
    count production over the pod — same bytes, N devices of count
    throughput."""
    with phase_timer("Banded exact + CSV ", enabled=verbose):
        compute_streamed_exact(
            presence,
            pairs.row_db_ids,
            pairs.col_db_ids,
            args.path_to_output_file,
            pairs.query_names,
            pairs.target_names,
            separator=args.separator,
            band=min(args.band, 512),
            col_chunk=min(args.col_chunk, 2048),
            resume=resume,
            row_denom_ids=pairs.row_denom_ids,
            col_denom_ids=pairs.col_denom_ids,
            staged=args.staged or None,
            mesh=mesh,
        )
    if verbose:
        print(
            f"Wrote {len(pairs.query_names)} x "
            f"{len(pairs.target_names)} AJI matrix to "
            f"{args.path_to_output_file} (banded exact)"
        )


def run(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    multiproc = _init_backend()
    from .parallel.distributed import is_primary

    primary = is_primary()
    # One writer, one reporter: non-primary processes compute (collectives)
    # but never touch the output files (reference has a single process;
    # multi-host output semantics follow its single printOutput call).
    verbose = not args.quiet and primary
    _enable_compilation_cache()
    if verbose:
        _print_args_box(args)
    try:
        if args.exact and not args.streamed:
            raise PFAAIError(
                ErrorCode.CONSTRUCT_ERROR,
                "--exact selects the banded exact engine and requires "
                "--streamed (the default path is already exact)",
            )
        if args.staged and not (args.fast or args.streamed):
            # The default exact path holds only integer count blocks, not
            # the presence tensor, on device; accepting --staged there would
            # silently do nothing — the OOM the flag promises to avoid
            # would still happen.
            raise PFAAIError(
                ErrorCode.CONSTRUCT_ERROR,
                "--staged stages the presence slabs of the banded device "
                "engines and requires --fast or --streamed",
            )
        if args.staged and args.mesh and not args.streamed:
            raise PFAAIError(
                ErrorCode.CONSTRUCT_ERROR,
                "--staged with --mesh requires --streamed (the staged-mesh "
                "slab engine is a streamed-path engine)",
            )
        if args.mesh:
            # Validate the spec HERE, on every process, before any
            # collective: a malformed --mesh that only the primary parses
            # (the meta-only guard below) would otherwise kill the primary
            # while the non-primaries sit in the presence broadcast.
            try:
                mesh_parts = [int(x) for x in args.mesh.split(",")]
                mesh_ok = len(mesh_parts) in (1, 2) and all(
                    p >= 1 for p in mesh_parts
                )
            except ValueError:
                mesh_ok = False
            if not mesh_ok:
                raise PFAAIError(
                    ErrorCode.CONSTRUCT_ERROR,
                    "--mesh expects ROWS or ROWS,SCP (positive integers), "
                    f"got {args.mesh!r}",
                )
            # Single parse point: every later site reads (rows, scp) from
            # here instead of re-splitting the string.
            mesh_rows = mesh_parts[0]
            mesh_scp = mesh_parts[1] if len(mesh_parts) > 1 else 1
        two_db = bool(args.query_db) and args.query_db != args.path_to_input_db
        # Single-reader ETL (multi-process runs): only the primary opens the
        # SQLite database at all — metadata and presence tensors are
        # broadcast to the other processes (parallel/distributed), so an
        # N-host launch reads the multi-GB database once, not N times.  DB
        # errors are broadcast in the payload's place so every process fails
        # with the same PFAAIError instead of deadlocking in a collective.
        db = None
        meta = None
        err = None
        if primary:
            try:
                with phase_timer("DB open + metadata ", enabled=verbose):
                    if two_db:
                        db = QueryTargetDatabase(
                            args.path_to_input_db, args.query_db
                        )
                    else:
                        db = SCPDatabase(args.path_to_input_db)
                    meta = db.meta
            except Exception as e:  # noqa: BLE001 — ANY primary failure must
                # reach the non-primaries, or they deadlock in the broadcast
                # collective below (a raw sqlite3.OperationalError on a
                # corrupt-but-present DB would otherwise kill only process 0).
                err = _as_pfaai_error(e)
        if multiproc:
            from .parallel.distributed import broadcast_pyobj

            meta = broadcast_pyobj(err if err is not None else meta)
            if isinstance(meta, PFAAIError):
                raise meta
        elif err is not None:
            raise err

        # Exact-path routing (decided from metadata alone, before any pair
        # space or presence tensor exists): the default bit-parity path
        # auto-routes through the banded exact engine when its dense host
        # footprint would exceed the budget — same f64 values, same CSV
        # bytes, bounded memory.  --dump-jac needs the per-pair JacResult, so
        # it pins the dense path.
        exact_default = not (args.fast or args.streamed or args.mesh)
        n_prot = len(meta.protein_set)
        n_tgt = len(meta.genome_set)
        banded_auto = False

        # The streamed engine consumes only the CSV axes; building the full
        # per-pair PairSpace would cost O(G^2) host memory — fatal at exactly
        # the genome counts --streamed exists for (modes.StreamAxes).
        if two_db:
            if exact_default and not args.dump_jac:
                banded_auto = _route_banded_exact(
                    len(meta.query_genome_set) * n_tgt, n_prot
                )
            use_axes = args.streamed or banded_auto
            mode_fn = query_target_axes if use_axes else query_target
            pairs = mode_fn(
                meta, compat_qt_t_swap=not args.no_compat_qt_t_swap
            )
        elif args.query_subset:
            # The query list, like the DB, may exist only on the primary's
            # disk (single-reader semantics): read once, broadcast the names
            # (or the error, so every process fails identically instead of
            # the primary stranding in the presence-broadcast collective).
            queries = err = None
            if primary:
                try:
                    queries = load_query_genomes(args.query_subset)
                except Exception as e:  # noqa: BLE001 — see DB open above
                    err = _as_pfaai_error(e)
            if multiproc:
                from .parallel.distributed import broadcast_pyobj

                queries = broadcast_pyobj(err if err is not None else queries)
                if isinstance(queries, PFAAIError):
                    raise queries
            elif err is not None:
                raise err
            if exact_default and not args.dump_jac:
                nq = len(queries)
                banded_auto = _route_banded_exact(
                    nq * (n_tgt - nq) + nq * (nq - 1) // 2, n_prot
                )
            use_axes = args.streamed or banded_auto
            mode_fn = query_subset_axes if use_axes else query_subset
            pairs = mode_fn(meta, queries)
        else:
            if exact_default and not args.dump_jac:
                banded_auto = _route_banded_exact(
                    n_tgt * (n_tgt - 1) // 2, n_prot
                )
            if args.streamed or banded_auto:
                pairs = all_vs_all_axes(meta)
            else:
                pairs = all_vs_all(meta)

        presence = None
        err = None
        if primary:
            try:
                with phase_timer("Presence ETL       ", enabled=verbose):
                    presence = db.load_presence(verbose=verbose)
            except Exception as e:  # noqa: BLE001 — see DB open above
                # (MemoryError on a multi-GB ETL is the plausible one here)
                err = _as_pfaai_error(e)
        if multiproc:
            from .parallel.distributed import broadcast_presence

            # Meta-only broadcast (primary decides, the header carries it):
            # staged-mesh runs never need the full tensor off-primary — the
            # slab store ships packed slab bytes on demand — so skipping
            # the presence broadcast keeps non-primary host RSS at
            # O(T + one slab) and genome capacity scaling with host RAM x
            # process count.
            meta_only = False
            if (
                primary
                and err is None
                and args.streamed
                and args.mesh
            ):
                # Primary-only code before broadcast_presence: any raise
                # here must funnel through err (the broadcast's error slot)
                # or the non-primaries hang in the broadcast collective.
                try:
                    from .engine import _use_host, _use_staged_mesh

                    # _use_host guard: the f32 streamed path routes
                    # host-trivial problems to host BLAS even under --mesh,
                    # and that path needs the full tensor everywhere
                    # (--exact always takes the mesh branch, so it skips
                    # the guard).
                    meta_only = (
                        args.exact or not _use_host(presence)
                    ) and _use_staged_mesh(
                        presence, mesh_scp, args.staged or None
                    )
                except Exception as e:  # noqa: BLE001 — see DB open above
                    err = _as_pfaai_error(e)
            with phase_timer("Presence broadcast ", enabled=verbose):
                presence = broadcast_presence(
                    presence, error=err, meta_only=meta_only
                )
            if verbose and getattr(presence, "slab_broadcast", False):
                print(
                    "Presence broadcast: metadata + T only (staged-mesh "
                    "slabs ship on demand; host capacity scales with the "
                    "pod)"
                )
        elif err is not None:
            raise err
        if args.dump_e and primary:
            from .etl.derive import derive_qsub, derive_qt, derive_single

            with phase_timer("E derivation       ", enabled=verbose):
                if two_db:
                    _, _, _, e = derive_qt(db)
                elif args.query_subset:
                    _, _, _, e = derive_qsub(db, queries)
                else:
                    _, _, _, e = derive_single(db)
                with open(args.dump_e, "w") as fp:
                    fp.write("proteinIndex,genomeA,genomeB\n")
                    for row in e:
                        fp.write(f"{row[0]},{row[1]},{row[2]}\n")
        if db is not None:
            db.close()
        profiler = None
        if args.profile:
            import jax.profiler as profiler

            profiler.start_trace(args.profile)
        if args.streamed:
            mesh = None
            if args.mesh:
                from .parallel.mesh import make_mesh

                mesh = make_mesh(mesh_rows, mesh_scp)
            if args.exact:
                _banded_exact_run(
                    args, presence, pairs, verbose, args.resume, mesh=mesh
                )
                if profiler is not None:
                    profiler.stop_trace()
                return 0
            with phase_timer("Streamed AJI + CSV ", enabled=verbose):
                compute_streamed(
                    presence,
                    pairs.row_db_ids,
                    pairs.col_db_ids,
                    args.path_to_output_file,
                    pairs.query_names,
                    pairs.target_names,
                    separator=args.separator,
                    band=args.band,
                    col_chunk=args.col_chunk,
                    resume=args.resume,
                    mesh=mesh,
                    row_denom_ids=pairs.row_denom_ids,
                    col_denom_ids=pairs.col_denom_ids,
                    staged=args.staged or None,
                )
            if profiler is not None:
                profiler.stop_trace()
            if verbose:
                print(
                    f"Wrote {len(pairs.query_names)} x {len(pairs.target_names)} "
                    f"AJI matrix to {args.path_to_output_file} (streamed)"
                )
            return 0
        if banded_auto:
            # Dense exact would exceed the host budget: same f64 values,
            # same CSV bytes, through the banded exact engine instead
            # (`pairs` is already the O(rows+cols) StreamAxes).
            if verbose:
                print(
                    "exact path: host footprint exceeds "
                    f"{_exact_host_budget() >> 30} GiB — routing through the "
                    "banded exact engine (identical CSV bytes; "
                    "PARFASTAAI_EXACT_HOST_BYTES overrides)"
                )
            _banded_exact_run(args, presence, pairs, verbose, args.resume)
            if profiler is not None:
                profiler.stop_trace()
            return 0
        with phase_timer("JAC + AJI          ", enabled=verbose):
            if args.mesh:
                result = compute_sharded(
                    presence, pairs, mesh_rows, mesh_scp
                )
            elif args.fast:
                result = compute_fast(
                    presence, pairs, staged=args.staged or None
                )
            else:
                result = compute(presence, pairs)
        if profiler is not None:
            profiler.stop_trace()
        if primary:
            with phase_timer("CSV write          ", enabled=verbose):
                write_aji_csv(
                    args.path_to_output_file, pairs, result.aji, args.separator
                )
        if args.dump_jac and primary:
            from .io.fmtfloat import format_double

            with open(args.dump_jac, "w") as fp:
                fp.write("genomeA,genomeB,S,N,AJI\n")
                for i in range(result.n_pairs):
                    fp.write(
                        f"{result.genome_a[i]},{result.genome_b[i]},"
                        f"{format_double(result.s[i])},{result.n[i]},"
                        f"{format_double(result.aji[i])}\n"
                    )
        if verbose:
            print(
                f"Wrote {result.n_pairs} genome-pair AJI values "
                f"({len(pairs.query_names)} x {len(pairs.target_names)} matrix) "
                f"to {args.path_to_output_file}"
            )
        return 0
    except PFAAIError as e:
        print(f"ERROR ({e.code.name}): {e}", file=sys.stderr)
        return int(e.code)


def main() -> None:
    raise SystemExit(run())


if __name__ == "__main__":
    main()
