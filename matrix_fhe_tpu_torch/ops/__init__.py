"""Modular arithmetic, transforms and the Hopper kernel wrappers."""
