"""The benchmark on the card: each cell briefly, and the control at a
cell's own size. Skips without a CUDA device."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


def _last_json(cmd):
    out = subprocess.run([sys.executable, *cmd], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return [json.loads(x) for x in out.stdout.strip().splitlines()
            if x.startswith("{")]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["mc.regress", "mc.debug"])
@pytest.mark.parametrize("traced", [0, 1])
def test_a_cell_runs_correct_on_the_card(card, workload, traced):
    out = _last_json(["rtlbench/run.py", "--workload", workload, "--seed",
                      "2147483659", "--seconds", "3", "--trace",
                      str(traced)])[-1]
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    if traced:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]


@pytest.mark.gpu
def test_the_control_is_not_correct_at_the_cells_size(card):
    (out,) = _last_json(["rtlbench/control.py", "--workload", "mc.regress",
                         "--seeds", "17"])
    assert not out["correct"]


@pytest.mark.gpu
@pytest.mark.parametrize("design,params", [("mc", {"n_walkers": 4})])
def test_the_reference_in_graphs_on_the_card_steps_as_numpy(card, design,
                                                            params):
    from rtlbench.stimuli import module
    gen = module(design)
    a = gen.build(params, 600, [1, 2, 3], 5)
    b = gen.build(params, 600, [1, 2, 3], 5, device="cuda")
    for k in a.expected:
        assert (a.expected[k] == b.expected[k]).all(), k
