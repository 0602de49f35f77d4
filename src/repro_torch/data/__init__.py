"""Deterministic synthetic token data for training."""
