"""Measurement scripts for the port; each runs as ``python -m``."""
