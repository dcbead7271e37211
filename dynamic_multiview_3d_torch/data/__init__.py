"""Data: the numpy synthetic scene bank and in-step preprocessing."""
