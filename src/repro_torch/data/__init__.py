"""Deterministic synthetic data (a copy of ``repro/data``)."""
