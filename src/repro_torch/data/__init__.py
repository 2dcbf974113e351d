"""Deterministic procedural datasets and the LM batch loader (port of
``repro.data``)."""
