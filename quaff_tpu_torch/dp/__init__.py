"""Banded pair-HMM DP for the port: the jax-free score tables, batch
layout and f64 engine (engine.py), the K1 score fill (fill_v2.py), and the
host traceback and debug dumps."""
