"""Drivers: how a traffic mix drives the program (``drivers/<name>.py``).

A driver has ``setup(run)``, which builds the suite and the engine and
warms every shape the window uses, and ``window(run, seconds)``.
"""
