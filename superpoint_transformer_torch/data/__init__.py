"""Padded batch representation."""
