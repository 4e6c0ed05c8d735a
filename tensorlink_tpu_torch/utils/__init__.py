"""Shared utilities (profiling, diagnostics)."""
