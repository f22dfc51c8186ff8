"""Optimizer of the training path (port of `repro.optim`)."""
