"""The LM scaffold across devices: meshes, sharding rules, placement and
the bucketed data-parallel step."""
