"""Stimulus suites: the design's netlist and each stimulus's initial state.

``stimuli/<design>.py`` holds a frozen copy of the port's builder for that
design (``repro_torch.circuits``), with the golden values taken from the
plain reference (``reference/<design>.py``) vectorised over the stimuli.
"""
from __future__ import annotations

import importlib


def module(design: str):
    """The generator of ``design`` (``stimuli/<design>.py``)."""
    return importlib.import_module(f"{__name__}.{design}")
