"""Synthetic request streams."""
