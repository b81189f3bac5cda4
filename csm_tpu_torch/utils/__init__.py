"""Utilities: synthetic training batches and the pattern overfit that
sharpens random weights."""
