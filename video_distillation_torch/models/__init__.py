"""Models: ConvNet3D, the 2-D ConvNet, the hallucinator and their building
blocks."""
