"""Utilities: phase profiling."""
