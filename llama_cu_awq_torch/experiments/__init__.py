"""Experiments of the JAX package's tools/experiments, ported with their
kernels. No engine path calls them; their tests and chip_smoke.py do."""
