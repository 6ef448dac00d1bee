"""Alias tables (host) and batched draws (device)."""
