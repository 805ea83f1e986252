"""The benchmark's harness: cells, inputs, loops, tracing and checks."""
