"""Datasets: metadata, the numpy stores and the synthetic test sets."""
