"""Synthetic key streams (numpy only)."""
