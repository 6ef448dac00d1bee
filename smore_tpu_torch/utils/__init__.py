"""Helpers that are not part of training: the benchmark graphs."""
