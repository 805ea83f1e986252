"""Models: ConvNet3D, the hallucinator and their building blocks."""
