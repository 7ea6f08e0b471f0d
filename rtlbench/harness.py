"""One run of one cell: set-up, the measured window, the check, the result.

Everything a cell needs is found by name from ``BENCHMARK.json``: its
configuration (the file its ``configs`` entry names), its traffic mix
(``traffic/<traffic>.json``), the driver the mix names
(``drivers/<driver>.py``), the design's generator and reference
(``stimuli/<design>.py``, ``reference/<design>.py``) and a reader for each
metric it reports (``metrics/<name>.py``, or for a quantity read alike in
several cells, ``metrics/<stem>.py`` of the name's part before its first
dot). Adding a cell, a mix or a metric adds files and entries; no file here
changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that may not be loaded in a run's process: JAX,
# and the JAX package and its benchmarks, of which the port is a copy
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


@dataclass
class Cell:
    """A ``workloads`` entry with its configuration, mix and metrics."""
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _reports(metric: dict, cell: str, e2e=None) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    list, else every cell (a per-layer metric: every cell that reports the
    end-to-end metric it moves, of the names ``e2e``)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e is None or metric["moves"] in e2e


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``root``'s ``BENCHMARK.json``."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; BENCHMARK.json has "
                       f"{', '.join(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads(
        (root / HERE.name / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in spec["end_to_end"] if _reports(m, workload)]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"] if _reports(m, workload, names)]
    return Cell(workload, int(w["chips"]), config, traffic, e2e, layer)


def metric_file(name: str, root: Path = ROOT) -> Path:
    """``metrics/<name>.py`` where there is one, else the reader of the
    quantity: ``metrics/idle_share.py`` for ``idle_share.debug``."""
    d = root / HERE.name / "metrics"
    own = d / f"{name}.py"
    return own if own.is_file() else d / f"{name.split('.', 1)[0]}.py"


def reader(name: str, root: Path = ROOT):
    """The ``read(run)`` function of the metric's file."""
    path = metric_file(name, root)
    spec = importlib.util.spec_from_file_location(
        f"rtlbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(name: str):
    """``drivers/<name>.py``: a mix names how it drives the program, so a
    later mix with another loop (a serving one) adds a driver file."""
    return importlib.import_module(f"{__package__}.drivers.{name}")


@dataclass
class Run:
    """What one run has made and measured; metric readers read it.

    Times are ``time.perf_counter_ns()``; ``epoch_ns`` is added to turn
    them into the profiler's clock. ``batches`` holds, per test batch of
    the window, its index in the suite, the ends of its ``images``,
    ``rebind`` and ``run_batch`` spans and the engine's ``chunks_s``;
    ``results`` the program's ``RunResult`` lists, in the same order.
    ``suite_s`` is the set-up's seconds in the stimulus suite and its
    reference, which ``setup_s`` leaves out."""
    cell: Cell
    seed: int
    devices: List[str]
    root: Path = ROOT
    t_process: int = 0
    epoch_ns: int = 0
    setup_s: float = 0.0
    suite_s: float = 0.0
    window: tuple = (0, 0)
    batches: List[dict] = field(default_factory=list)
    results: List[list] = field(default_factory=list)
    trace: Optional[object] = None
    # set by the driver
    suite: Optional[object] = None
    program: Optional[object] = None
    engine: Optional[object] = None
    benches: list = field(default_factory=list)
    batch: int = 1
    budget: int = 0

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    @property
    def tests(self) -> int:
        """Tests run to their end in the window."""
        return sum(len(r) for r in self.results)

    def spans(self, name: str):
        """``(start, end)`` of every span ``name`` in the window."""
        i = {"images": ("t0", "t1"), "rebind": ("t1", "t2"),
             "run_batch": ("t2", "t3")}[name]
        return [(b[i[0]], b[i[1]]) for b in self.batches]


def device_info(run: Run, trace: bool) -> dict:
    """The ``device`` entry: the card, how many, the fullest one's peak."""
    import torch
    if run.devices[0].startswith("cuda"):
        kind = torch.cuda.get_device_name(0)
        peak = max(torch.cuda.max_memory_allocated(d)
                   for d in dict.fromkeys(run.devices))
        out = {"platform": "gpu", "kind": kind}
    else:
        peak, out = 0, {"platform": "cpu", "kind": "cpu"}
    out.update(count=len(dict.fromkeys(run.devices)),
               memory_peak_bytes=int(peak))
    if trace and run.trace is not None:
        out.update(busy_s=run.trace.busy_s(), window_s=run.trace.window_s)
    return out


def _report_spans(run: Run) -> None:
    """Set-up and each span's spread over the window's batches, on
    standard error (the numbers compared come last)."""
    parts = [f"setup {run.setup_s:.3f} s (suite {run.suite_s:.3f} s "
             f"apart), {len(run.batches)} batches"]
    for name in ("images", "rebind", "run_batch"):
        ms = sorted((b - a) / 1e6 for a, b in run.spans(name))
        parts.append(f"{name} ms min {ms[0]:.1f} median "
                     f"{ms[len(ms) // 2]:.1f} max {ms[-1]:.1f}")
    print("window: " + "; ".join(parts), file=sys.stderr)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is in ``FORBIDDEN``."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def measure(workload: str, seed: int, seconds: float, trace: bool,
            devices: List[str], root: Path = ROOT,
            t_process: Optional[int] = None) -> dict:
    """Set up, measure for ``seconds``, check; the result's line as a dict.
    ``devices`` are the run's devices, one a chip (``cuda:i``), or the CPU
    (``cpu``) where the kernels' plain versions stand in (tests only)."""
    from . import check
    from . import trace as tr

    cell = load_cell(workload, root)
    run = Run(cell, int(seed), list(devices), root,
              t_process or time.perf_counter_ns())
    drv = driver(cell.traffic["driver"])
    drv.setup(run)
    prof = tr.start(run.devices) if trace else None
    run.epoch_ns = time.time_ns() - time.perf_counter_ns()
    t0 = time.perf_counter_ns()
    run.setup_s = (t0 - run.t_process) / 1e9 - run.suite_s
    run.window = (t0, drv.window(run, seconds))
    _report_spans(run)
    if prof is not None:
        run.trace = tr.stop(prof, run)
    device = device_info(run, trace)
    run.engine = None
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = reader(m["name"], root)(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    checks, attempted, failed = check.compare(run)
    out = {"correct": check.correct(checks, attempted),
           "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": device}
    if run.trace is not None:
        out["breakdown"] = run.trace.breakdown(run)
    out["checks"] = checks
    return out
