"""Fixtures of the benchmark's tests: a tiny checkout of the benchmark."""
import json
import shutil
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (CUDA); skips without one")


def tiny_root(root: Path) -> Path:
    """A copy of the benchmark's data at a size the CPU runs in a second:
    every cell's design cut to 4 walkers or cores, every test to 32
    cycles, a suite of 8 stimuli (the four-card mix over two CPU shards),
    compiled into the copy's own cache."""
    spec = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    for d in ("configs", "traffic", "metrics"):
        shutil.copytree(HERE / d, root / "rtlbench" / d)
    for c in spec["configs"]:
        p = root / c["file"]
        cfg = json.loads(p.read_text())
        cfg["params"] = {k: 4 for k in cfg["params"]}
        p.write_text(json.dumps(cfg))
    for p in (root / "rtlbench" / "traffic").glob("*.json"):
        mix = json.loads(p.read_text())
        mix.update(test_cycles=32, suite=8, chips=mix["chips"],
                   batch=1 if mix["batch"] == 1 else
                   8 if mix["engine"] == "sharded" else 4)
        if mix["batch"] == 1:
            mix["suite"] = 1
        p.write_text(json.dumps(mix))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("rtlbench"))


@pytest.fixture
def card():
    """Skips where no CUDA device is present; decided here, never at import."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    return torch
