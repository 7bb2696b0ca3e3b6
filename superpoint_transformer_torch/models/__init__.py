"""SPT backbone and task models."""
