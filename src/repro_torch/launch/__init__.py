"""Launchers of the port (one card)."""
