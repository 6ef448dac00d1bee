"""Helpers beside training: checkpoints and the benchmark graphs."""
