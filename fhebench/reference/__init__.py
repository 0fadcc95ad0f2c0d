"""The benchmark's plain reference: torch, numpy and the standard library
only, never the program under test or JAX."""
