"""Counts that do not move with the program: each configuration's model
FLOPs, the bytes of the port's kernels at a cell's shapes, the card's peaks."""
