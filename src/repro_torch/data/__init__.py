"""Synthetic temporal datasets (numpy copy of ``repro.data``)."""
