"""Model code: building blocks, attention, and the LM (dense family)."""
