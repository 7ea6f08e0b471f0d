"""Synthetic token data: a counter-based pipeline (a copy of the reference's)."""
