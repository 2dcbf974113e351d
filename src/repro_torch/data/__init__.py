"""Deterministic procedural datasets (port of ``repro.data``)."""
