"""rtlbench: the benchmark of the PyTorch and CUDA port (``repro_torch``).

Run one cell from the root of a checkout::

    python3 rtlbench/run.py --workload mc.regress --seed 7 --seconds 20 \
        --trace 0

``BENCHMARK.json`` names the cells; each cell's configuration, traffic mix
and per-layer metric readers are files under this folder, found by name
(``configs/<name>.json``, ``traffic/<name>.json``, ``metrics/<name>.py``).
"""
