"""Embedding text IO."""
