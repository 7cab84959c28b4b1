"""CPU tests of the benchmark harness. A test that needs the card is marked
``cuda`` and skips without one. ``small_bench`` is a copy of the benchmark
in a temporary directory with the same widths and smaller scales (fewer
hits and vertices, smaller batches, a coarser mesh, a smaller image, a
shorter orbit)."""
from __future__ import annotations

import json
import os
import shutil
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the port's kernels); skips without one")


def pytest_collection_modifyitems(config, items):
    if torch.cuda.is_available():
        return
    skip = pytest.mark.skip(reason="needs a CUDA device: the port's kernels run only on the card")
    for item in items:
        if "cuda" in item.keywords:
            item.add_marker(skip)


def edit_json(path, fn):
    with open(path) as f:
        d = json.load(f)
    fn(d)
    with open(path, "w") as f:
        json.dump(d, f)


def make_small_bench(root, batch=256, blocks=100):
    """(registry root, Registry) of a copy of the benchmark under `root`
    with the same widths and smaller scales: `blocks` train blocks of
    `batch` rows, a coarser mesh, a smaller image, a shorter orbit."""
    from benchmark.registry import Registry

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    c = root / "benchmark" / "configs"

    def cat(d):
        d["training"]["batch_size"] = batch
        d["train_data"] = {"num_vertices": 300, "num_hits": batch * blocks}
        d["render_data"]["mesh"]["subdivisions"] = 2
        d["data"]["img_height"] = d["data"]["img_width"] = 40

    def vd(d):
        d["training"]["batch_size"] = batch
        d["train_data"] = {"mesh": {"kind": "blob", "subdivisions": 2},
                           "num_hits": batch * blocks + 5}

    def orbit(d):
        d.update(views=3, sample_below=4, sample_frames=2)

    edit_json(c / "intrinsic_cat.json", cat)
    edit_json(c / "viewdep_intrinsic_blob.json", vd)
    edit_json(root / "benchmark" / "traffic" / "render_orbit.json", orbit)
    return root, Registry(root=str(root))


@pytest.fixture
def small_bench(tmp_path):
    """The benchmark at small scale: an epoch of 100 train blocks of 256
    rows, long enough for Adam's bias correction and the block order to
    show."""
    return make_small_bench(tmp_path)
