"""Distillation: the S2D parameterization, MTT, expert buffers and DC
static learning."""
