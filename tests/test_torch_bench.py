"""``bench_torch.py`` on the CPU at a small grid: the schema of its one JSON
line, its grid rule against ``bench.py``'s, and its refusal to run without
a CUDA device. The numbers mean nothing here."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_PY_KEYS = {"metric", "value", "unit", "vs_baseline", "sec_per_step",
                 "grid", "steps", "case", "fast_spectral",
                 "solve_rel_err_class"}
PORT_KEYS = {"backend", "device", "device_ms_per_step", "kernels_per_step"}


def _run(**env):
    env = {**{k: v for k, v in os.environ.items()
              if not k.startswith("BENCH_") and k != "PYTHONPATH"}, **env}
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "bench_torch.py")], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("case,grid", [
    ("sphere", [16, 16, 16]), ("rod", [32, 8, 32]),
    ("multibody", [16, 16, 32]), ("cylinder", [32, 64]),
])
def test_bench_torch_prints_one_json_line(case, grid):
    g = {"sphere": 16}.get(case, 32)
    proc = _run(BENCH_DEVICE="cpu", BENCH_CASE=case, BENCH_GRID=str(g),
                BENCH_STEPS="2")
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, proc.stdout
    out = json.loads(lines[0])
    assert set(out) == BENCH_PY_KEYS | PORT_KEYS
    assert out["backend"] == "torch" and out["device"] == "cpu"
    assert out["case"] == case and out["grid"] == grid and out["steps"] == 2
    assert out["unit"] == "Mcells/s" and out["value"] > 0
    assert out["sec_per_step"] > 0
    assert out["metric"].startswith(f"{len(grid)}d_fsi_{case}_")
    # nothing of the device was measured on the CPU, the fused route needs
    # the card, and no baseline is restated for the port
    assert out["device_ms_per_step"] is None
    assert out["kernels_per_step"] is None
    assert out["fast_spectral"] is False and out["vs_baseline"] is None


def test_bench_torch_grid_rule_and_refusals():
    sys.path.insert(0, REPO)
    try:
        import bench_torch
    finally:
        sys.path.remove(REPO)
    # bench.py's rule (it imports JAX at call time only)
    import bench

    for case in ("sphere", "rod", "multibody"):
        for g in (16, 64, 256):
            assert bench_torch._case_grid(case, g) == bench._case_grid(case, g)
    assert bench_torch._case_grid("cylinder", 256) == (256, 512)
    # without a CUDA device: exit code 2 and no result
    import torch

    if not torch.cuda.is_available():
        proc = _run(BENCH_GRID="16", BENCH_STEPS="1")
        assert proc.returncode == 2 and not proc.stdout.strip()
        assert "no CUDA device" in proc.stderr
    proc = _run(BENCH_DEVICE="cpu", BENCH_CASE="torus")
    assert proc.returncode != 0 and "BENCH_CASE" in proc.stderr
