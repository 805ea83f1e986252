"""Plain float32 PyTorch yardstick of the benchmark; imports nothing of the
program under test."""
