"""The harness on the CPU at a tiny size: data-driven lookup, the result's
keys, the comparison that decides ``correct``, the faults it catches."""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from rtlbench import check, harness, roofline, trace
from rtlbench.control import control_checks
from rtlbench.reference import Exact, NoCarry

REPO = Path(__file__).resolve().parent.parent
NAME = r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$"
SECONDS = 0.2


def devices(root, workload):
    return ["cpu"] * harness.load_cell(workload, root).chips


def run(root, workload, seed=2**31 + 5, trace_=False):
    return harness.measure(workload, seed, SECONDS, trace_,
                           devices(root, workload), root=root)


def test_benchmark_json_meets_the_contracts_shape():
    import re
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    assert spec["command"] == ["python3", "rtlbench/run.py"]
    assert spec["paths"] == ["rtlbench"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in spec[k]]
    assert len(names) == len(set(names))
    assert all(re.match(NAME, n) for n in names)
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for c in spec["configs"]:
        assert (REPO / c["file"]).is_file()
    for w in spec["workloads"]:
        assert (REPO / "rtlbench" / "traffic" /
                f"{w['traffic']}.json").is_file()
        cell = harness.load_cell(w["name"], REPO)
        assert len(cell.end_to_end) >= 2 and cell.per_layer, w["name"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert m.get("moves", "setup_s") in e2e
        assert harness.metric_file(m["name"], REPO).is_file(), m["name"]


@pytest.mark.parametrize("workload", ["mc.regress", "mc.debug"])
def test_a_sound_run_is_correct_and_its_line_has_the_keys(tiny, workload):
    out = run(tiny, workload)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"] and out["attempted"] > 0 and out["failed"] == 0
    cell = harness.load_cell(workload, tiny)
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        out["device"])
    assert all(c["value"] == 0 and c["limit"] == 0
               for c in out["checks"].values())


def test_the_four_card_mix_runs_over_shards(tiny):
    spec = json.loads((tiny / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "mc.regress4", "config": "mc",
                              "traffic": "regress4", "chips": 4,
                              "why": "four shards"})
    root = tiny / "four"
    if not root.exists():
        root.mkdir()
        (root / "rtlbench").symlink_to(tiny / "rtlbench")
        (root / "BENCHMARK.json").write_text(json.dumps(spec))
    out = run(root, "mc.regress4")
    assert out["correct"] and out["attempted"] == 8


def test_a_cell_a_mix_and_a_metric_added_as_files_are_picked_up(tmp_path):
    from rtlbench.conftest import tiny_root
    root = tiny_root(tmp_path)
    (root / "new").mkdir()
    cfg = json.loads((root / "rtlbench/configs/mc.json").read_text())
    cfg["params"] = {"n_walkers": 6}
    (root / "new/mc6.json").write_text(json.dumps(cfg))
    (root / "rtlbench/traffic/two.json").write_text(json.dumps(
        {"driver": "suite", "engine": "batched", "suite": 4, "batch": 2,
         "test_cycles": 20, "chips": 1}))
    (root / "rtlbench/metrics/tests_done.py").write_text(
        "def read(run):\n    return run.tests\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "mc6", "source": "x",
                            "file": "new/mc6.json", "reduced": [],
                            "why": "x"})
    spec["workloads"].append({"name": "mc6.two", "config": "mc6",
                              "traffic": "two", "chips": 1, "why": "x"})
    spec["end_to_end"].append({"name": "tests_done", "unit": "tests",
                               "better": "higher", "bound": 0.01,
                               "source": "host_clock",
                               "workloads": ["mc6.two"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    out = run(root, "mc6.two")
    assert out["correct"]
    assert out["metrics"]["tests_done"]["value"] == out["attempted"] > 0
    assert set(out["metrics"]) == {"setup_s", "tests_done"}


def test_setup_s_leaves_out_the_suite_and_its_reference(tiny, monkeypatch):
    """The reference's goldens are made in set-up, but ``setup_s`` leaves
    their seconds out: a suite made two seconds slower moves it by none."""
    import time
    from rtlbench.drivers import suite as drv
    slow = drv.make_suite
    monkeypatch.setattr(drv, "make_suite",
                        lambda r: (time.sleep(2.0), slow(r))[1])
    t0 = time.perf_counter_ns()
    out = harness.measure("mc.regress", 2**31 + 7, SECONDS, False,
                          devices(tiny, "mc.regress"), root=tiny,
                          t_process=t0)
    wall = (time.perf_counter_ns() - t0) / 1e9
    assert out["correct"]
    assert out["metrics"]["setup_s"]["value"] < wall - 2.0


def _break(monkeypatch, fault):
    """Plant ``fault`` in the program's timed path."""
    from repro_torch.core import bsp
    from repro_torch.sim import engine as se

    def wrap(cls, name, make):
        monkeypatch.setattr(cls, name, make(getattr(cls, name)))

    if fault == "state_unchanged":
        for cls in (bsp.Machine, bsp.BatchedMachine,
                    bsp.ShardedBatchedMachine):
            wrap(cls, "run", lambda keep: lambda self, state, n: state)
    elif fault == "half_the_batch_left_out":
        for cls in (se.BatchedEngine, se.ShardedBatchedEngine):
            wrap(cls, "run_batch", lambda keep: lambda self, n: keep(
                self, n)[:self.batch // 2])
    elif fault == "shard_left_out":
        def one_shard(keep):
            def run(self, state, n):
                kernels, self._kernels = self._kernels, self._kernels[:1]
                try:
                    return keep(self, state, n)
                finally:
                    self._kernels = kernels
            return run
        wrap(bsp.ShardedBatchedMachine, "run", one_shard)
    elif fault == "register_altered":
        def flip(keep):
            def dispatch(*args):
                carry = keep(*args)
                return (carry[0] ^ 1,) + tuple(carry[1:])
            return dispatch
        monkeypatch.setattr(bsp, "dispatch_chunks",
                            flip(bsp.dispatch_chunks))


FAULTS = [("mc.regress", "state_unchanged"),
          ("mc.debug", "state_unchanged"),
          ("mc.regress", "half_the_batch_left_out"),
          ("mc.regress4", "shard_left_out"),
          ("mc.regress", "register_altered"),
          ("mc.debug", "register_altered")]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_a_planted_fault_makes_correct_false(tiny, monkeypatch, workload,
                                             fault):
    root = tiny
    if workload == "mc.regress4":
        test_the_four_card_mix_runs_over_shards(tiny)
        root = tiny / "four"
    _break(monkeypatch, fault)
    out = run(root, workload)
    assert not out["correct"], out["checks"]
    assert out["failed"] > 0


@pytest.mark.parametrize("workload", ["mc.regress", "mc.debug"])
def test_the_control_comes_out_not_correct(tiny, workload):
    cell = harness.load_cell(workload, tiny)
    out = control_checks(harness.Run(cell, 3, ["cpu"], tiny), NoCarry)
    assert not out["correct"]
    assert out["checks"]["wrong_registers"]["value"] > 0
    exact = control_checks(harness.Run(cell, 3, ["cpu"], tiny), Exact)
    assert exact["correct"]


def test_no_module_of_jax_or_the_jax_package_on_the_run_path(tiny):
    code = ("import sys; from rtlbench import harness; "
            f"harness.measure('mc.regress', 9, {SECONDS}, False, ['cpu'], "
            f"root=__import__('pathlib').Path({str(tiny)!r})); "
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env={"PYTHONPATH": f"{REPO}:{REPO / 'src'}",
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_the_command_prints_nothing_and_fails():
    out = subprocess.run(
        [sys.executable, "rtlbench/run.py", "--workload", "mc.regress",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=REPO,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def test_the_trace_reduction_on_a_made_up_timeline():
    ms = 1_000_000
    ev = [(0, "vcycle_chunk_kernel", 1 * ms, 3 * ms),
          (0, "vcycle_chunk_kernel", 4 * ms, 6 * ms),
          (0, "Memcpy DtoH", 6 * ms, 7 * ms),
          (0, "vcycle_chunk_kernel", 12 * ms, 13 * ms)]
    spans = {"images": [(0, 1 * ms)], "rebind": [(1 * ms, 1 * ms)],
             "run_batch": [(1 * ms, 8 * ms), (11 * ms, 14 * ms)]}
    t = trace.Trace(ev, 0, 20 * ms, 1, spans)
    assert t.busy_s() == pytest.approx(6e-3)
    assert t.idle_share() == pytest.approx(70.0)
    assert list(t.chunk_gaps_ns()) == [1 * ms]
    assert t.chunk_s() == pytest.approx(5e-3)
    idle = t.idle_by_span()
    assert idle["images"] == pytest.approx(1e-3)
    assert idle["run_batch"] == pytest.approx(4e-3)
    assert idle["other"] == pytest.approx(9e-3)
    assert sum(idle.values()) == pytest.approx(14e-3)
    bd = t.breakdown(None)
    assert bd["device_ops"][0] == ["vcycle_chunk_kernel", pytest.approx(5e-3)]


@pytest.mark.parametrize("design", ["mc"])
def test_the_roofline_counts_the_rows_the_kernel_binds(design):
    """The frozen count of live rows and the busiest core's agrees with
    the chunk kernel's row tables at today's binding."""
    import repro_torch.sim as sim
    from repro_torch.kernels.rows import chunk_rows
    p = sim.compile(design, scale="small", seeds=[1, 2],
                    device="cpu").program
    C = p.used_cores
    t = chunk_rows(np.transpose(p.code[:C], (1, 0, 2)),
                   p.send_capture(C), p.luts, C, int(p.pipe_prologue),
                   p.n_sends, device="cpu")
    w = roofline.chunk_work(p)
    assert (w.rows, w.busiest) == (t.n_rows, t.busy)
    assert roofline.launch_bytes(w, 2) > roofline.launch_bytes(w, 1)


def test_check_lines_name_each_number_and_its_limit():
    checks = {"missing": {"value": 0, "limit": 0}}
    assert check.lines(checks) == ["check missing 0 limit 0"]
