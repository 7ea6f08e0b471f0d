"""The port's copied compiler and artifacts against the reference package,
and the port's independence from JAX.

``repro_torch`` keeps its own copies of the numpy-only compiler, circuit
and artifact modules; both packages must compile byte-identical Programs
and read each other's ``.npz`` artifacts unchanged.
"""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.sim as jsim
from repro.circuits import CIRCUITS, build as jbuild
from repro.core.compile import compile_circuit as jcompile
from repro.core.isa import HardwareConfig as JHW

import repro_torch.sim as tsim
from repro_torch.circuits import build as tbuild
from repro_torch.core.compile import compile_circuit as tcompile
from repro_torch.core.isa import HardwareConfig as THW

ROOT = Path(__file__).resolve().parents[1]
NAMES = sorted(CIRCUITS)
ARRAYS = ("code", "luts", "reg_init", "spad_init", "gmem_init",
          "xchg_src_core", "xchg_src_slot", "xchg_dst_core", "xchg_dst_reg")


def assert_same_program(a, b):
    for f in ARRAYS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert x.tobytes() == y.tobytes(), f
    for f in ("name", "t_compute", "vcpl", "used_cores", "pipe_prologue",
              "outputs", "state_regs"):
        assert getattr(a, f) == getattr(b, f), f
    assert dataclasses.asdict(a.hw) == dataclasses.asdict(b.hw)


@pytest.mark.parametrize("name", NAMES)
def test_copied_compiler_is_byte_identical(name):
    jp = jcompile(jbuild(name, "small").circuit,
                  JHW(grid_width=5, grid_height=5))
    tp = tcompile(tbuild(name, "small").circuit,
                  THW(grid_width=5, grid_height=5))
    assert_same_program(jp, tp)
    assert jp.op_set() == tp.op_set()
    np.testing.assert_array_equal(jp.send_capture(jp.used_cores),
                                  tp.send_capture(tp.used_cores))
    # no two exchange entries share a destination register: the reference's
    # scatter would pick an unspecified winner, the kernel another
    cells = set(zip(tp.xchg_dst_core.tolist(), tp.xchg_dst_reg.tolist()))
    assert len(cells) == tp.n_sends


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_artifacts_load_across_packages(direction, tmp_path):
    hw = dict(grid_width=5, grid_height=5)
    path = tmp_path / "bc.npz"
    if direction == "jax_to_torch":
        src = jsim.compile("bc", JHW(**hw), scale="full")
        src.save(path)
        loaded = tsim.load(path, device="cpu").program
    else:
        src = tsim.compile("bc", THW(**hw), scale="full", device="cpu")
        src.save(path)
        loaded = jsim.load(path).program
    assert src.program.pipe_prologue > 0
    assert_same_program(src.program, loaded)
    assert loaded.stats["fingerprint"] == src.program.stats["fingerprint"]


def _port_sources():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    assert len(files) > 20
    return files + [ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_reference():
    """Checked on the syntax tree of every module: no ``import jax``, no
    absolute import of ``repro`` (relative imports stay in the port)."""
    bad = []
    for path in _port_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for nm in names:
                top = nm.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    bad.append(f"{path.relative_to(ROOT)}:{node.lineno} {nm}")
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok', len([k for k in sys.modules "
        "if k.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
