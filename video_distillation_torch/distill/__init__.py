"""Distillation: the S2D parameterization, MTT and expert buffers."""
