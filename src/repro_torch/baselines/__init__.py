"""Baselines the paper compares MATADOR against (Table I)."""
