"""Launchers of the port (training under ``torchrun`` too), its device
meshes and its sharding rules."""
