"""Embedding models."""
