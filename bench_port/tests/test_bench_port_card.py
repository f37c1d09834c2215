"""Short runs of every cell on a CUDA card, as the benchmark's command
runs them (``python -m pytest bench_port/tests -m cuda`` on the card);
skipped without one."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from bench_port import harness

CELLS = [w["name"] for w in harness.load_json(
    os.path.join(harness.ROOT, "BENCHMARK.json"))["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card_is_correct(cell, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    proc = subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 77), "--seconds", "2", "--trace", str(trace)],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.splitlines()[-1])
    assert result["correct"], result["check"]
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["kind"] == torch.cuda.get_device_name(0)
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        assert result["breakdown"]["device_ops"]
