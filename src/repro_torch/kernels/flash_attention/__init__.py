"""Package of the port; see the modules."""
