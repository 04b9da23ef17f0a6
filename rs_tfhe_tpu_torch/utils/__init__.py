"""Utilities: the noise model (utils/noise.py)."""
