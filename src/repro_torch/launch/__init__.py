"""Step builders over the port's models."""
