"""Data sources: the numpy synthetic scene bank."""
