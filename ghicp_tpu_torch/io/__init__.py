"""Synthetic scenes and pairs (numpy only)."""
