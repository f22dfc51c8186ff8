"""Synthetic data pipeline (port of `repro.data`)."""
