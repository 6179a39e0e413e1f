"""Serving runtime: fault injection, straggler monitor, async gateway."""
