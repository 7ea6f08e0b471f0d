"""Runtime services: ``elastic`` moves a running RTL simulation's state
between two compilations of one circuit; ``checkpoint`` saves and restores
the LM's training state; ``health`` watches hosts' heartbeats."""
