"""Segment ops and the attention kernel."""
