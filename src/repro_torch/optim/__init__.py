"""Optimizers (AdamW with fp32 state) and learning-rate schedules."""
