"""Fixtures of the benchmark's CPU tests: a copy of the benchmark at test
sizes beside the real port."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench_port.reference.scene import build, screen_box  # noqa: E402

# the test sizes: a few pixels of a few frames, the same scenes and paths
_SETTINGS = {"max_bounces": 1, "diffuse_bounce": False}
SIZES = {"frog_1080p": (64, 32), "spheres_540p": (64, 32)}


def small_copy(dest: str) -> str:
    """A checkout at ``dest`` holding ``BENCHMARK.json`` and the benchmark
    with its configurations at test sizes, the port and the meshes
    linked in; returns its root."""
    os.makedirs(dest, exist_ok=True)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dest)
    shutil.copytree(BENCH, os.path.join(dest, "bench_port"),
                    ignore=shutil.ignore_patterns(".cache", "out",
                                                  "__pycache__"))
    os.symlink(os.path.join(ROOT, "raytracinginonesemester_tpu_torch"),
               os.path.join(dest, "raytracinginonesemester_tpu_torch"))
    os.makedirs(os.path.join(dest, "tests"))
    os.symlink(os.path.join(ROOT, "tests", "assets"),
               os.path.join(dest, "tests", "assets"))
    for name, (w, h) in SIZES.items():
        path = os.path.join(dest, "bench_port", "configs", f"{name}.json")
        with open(path) as f:
            cfg = json.load(f)
        cfg["camera"]["pixel_width"], cfg["camera"]["pixel_height"] = w, h
        if "check_box" in cfg:
            cfg["check_box"] = list(screen_box(build(cfg, _SETTINGS, ROOT)))
        with open(path, "w") as f:
            json.dump(cfg, f)
    tdir = os.path.join(dest, "bench_port", "traffic")
    for name in os.listdir(tdir):
        with open(os.path.join(tdir, name)) as f:
            traffic = json.load(f)
        if "frames_per_call" in traffic:
            traffic["frames_per_call"] = min(2, traffic["frames_per_call"])
            traffic["check_pixels_per_call"] = 64
        if "restart_every" in traffic:
            traffic["restart_every"] = 3
        with open(os.path.join(tdir, name), "w") as f:
            json.dump(traffic, f)
    return dest


@pytest.fixture(scope="session")
def small_root(tmp_path_factory):
    return small_copy(str(tmp_path_factory.mktemp("bench") / "root"))


@pytest.fixture(autouse=True)
def _cpu_env(monkeypatch, small_root):
    """The port's knobs at their defaults, its caches in the copy, one
    PyTorch thread."""
    import torch

    from bench_port import harness

    for key in [k for k in os.environ if k.startswith("RT_")]:
        monkeypatch.delenv(key)
    for key, value in harness.cache_env(small_root).items():
        monkeypatch.setenv(key, value)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
