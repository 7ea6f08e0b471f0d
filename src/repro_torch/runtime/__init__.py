"""Runtime services over the engines: ``elastic`` moves a running RTL
simulation's state between two compilations of one circuit."""
