"""Model configurations (the paper's TMs)."""
