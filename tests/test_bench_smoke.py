"""Smoke tests for the bench entry points.

``python bench.py`` prints one JSON line; each mode is exercised here
in-process on the CPU backend at a tiny G.  The compile cache goes where
JAX_COMPILATION_CACHE_DIR says.
"""

import importlib
import json
import os
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bench_kernel_main_prints_one_json_line(monkeypatch, capsys, tmp_path):
    monkeypatch.setenv("PARFASTAAI_BENCH_G", "64")
    monkeypatch.setenv("PARFASTAAI_BENCH_STEPS", "8")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jit"))
    sys.path.insert(0, REPO_ROOT)
    try:
        bench = importlib.import_module("bench")
        bench.main()
    finally:
        sys.path.remove(REPO_ROOT)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1, lines
    rec = json.loads(lines[0])
    assert rec["unit"] == "pairs/s"
    assert rec["value"] > 0
    assert rec["vs_baseline"] > 0
    assert rec["int8_mac_per_s"] > 0
    # CPU backend has no spec int8 peak -> mfu must be None, not garbage.
    assert rec["mfu"] is None
    assert "G=64" in rec["metric"]
    assert (rec["platform"], rec["device_count"]) == ("cpu", 8)
    assert rec["device_kind"]


def test_bench_mesh_mode_prints_curve(monkeypatch, capsys, tmp_path):
    """PARFASTAAI_BENCH_MODE=mesh sweeps mesh shapes over the 8 virtual CPU
    devices and emits pairs/s/chip + efficiency per shape — the harness
    that makes BASELINE.json's scaling-efficiency target measurable the day
    an N-chip slice exists."""
    monkeypatch.setenv("PARFASTAAI_BENCH_G", "32")
    monkeypatch.setenv("PARFASTAAI_BENCH_STEPS", "8")
    monkeypatch.setenv("PARFASTAAI_BENCH_REPS", "2")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jit"))
    sys.path.insert(0, REPO_ROOT)
    try:
        bench = importlib.import_module("bench")
        bench.main_mesh()
    finally:
        sys.path.remove(REPO_ROOT)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1, lines
    rec = json.loads(lines[0])
    assert rec["unit"] == "pairs/s"
    shapes = rec["shapes"]
    # 8 virtual devices: (1,1), (2,1), (4,1), (8,1), (4,2).
    assert [s["mesh"] for s in shapes] == ["1x1", "2x1", "4x1", "8x1", "4x2"]
    assert shapes[0]["efficiency_vs_1chip"] == 1.0
    # CPU wall-clock noise at toy G can flip a tiny slope's sign, so the
    # smoke test pins structure (every shape measured, fields present and
    # finite) rather than magnitudes — magnitudes are a hardware claim.
    import math

    for s in shapes:
        assert s["chips"] >= 1
        assert math.isfinite(s["pairs_per_sec"]) and s["pairs_per_sec"] != 0
        assert math.isfinite(s["efficiency_vs_1chip"])
    assert math.isfinite(rec["direct_pairs_per_sec"])
    assert math.isfinite(rec["mesh_vs_direct_1chip"])


def test_bench_e2e_mode_with_exact_and_mesh_legs(
    monkeypatch, capsys, tmp_path
):
    """PARFASTAAI_BENCH_MODE=e2e at toy G on the CPU backend: one JSON line
    with phases, wire-byte figures, the banded-exact leg, and the
    mesh-sanity leg (PARFASTAAI_BENCH_EXACT_MESH) whose CSV must be
    byte-identical to the direct exact leg."""
    monkeypatch.setenv("PARFASTAAI_BENCH_G", "64")
    monkeypatch.setenv("PARFASTAAI_BENCH_DB", str(tmp_path / "synth64.db"))
    monkeypatch.setenv("PARFASTAAI_BENCH_EXACT", "1")
    monkeypatch.setenv("PARFASTAAI_BENCH_EXACT_MESH", "1,1")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jit"))
    monkeypatch.delenv("PARFASTAAI_FORCE_DEVICE", raising=False)
    sys.path.insert(0, REPO_ROOT)
    try:
        bench = importlib.import_module("bench")
        bench.main_e2e()
    finally:
        sys.path.remove(REPO_ROOT)
        os.environ.pop("PARFASTAAI_FORCE_DEVICE", None)  # set by main_e2e
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1, lines
    rec = json.loads(lines[0])
    assert rec["unit"] == "s"
    ph = rec["phases"]
    for key in ("db_open", "etl", "fused_aji", "csv", "streamed_aji_csv",
                "banded_exact_csv", "banded_exact_mesh_csv"):
        assert key in ph, key
    assert ph["banded_exact_mesh_bytes_identical"] is True
    wire = rec["wire_bytes"]
    # P=80, G=64: packed presence = 80*64*K/8 with K the compacted width.
    assert wire["upload_packed_presence_bytes"] % (80 * 64 // 8) == 0
    assert wire["streamed_download_bytes"] == 4 * (64 * 64 // 2)
    assert wire["exact_download_bytes"] == 2 * 80 * (64 * 64 // 2)
    assert rec["exact_wall_seconds"] > 0
