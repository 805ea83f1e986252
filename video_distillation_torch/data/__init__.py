"""Datasets: metadata, the numpy stores, the offline packer and the
synthetic test sets."""
