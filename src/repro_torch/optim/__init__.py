"""Optimizers (AdamW, SGD) and learning-rate schedules."""
