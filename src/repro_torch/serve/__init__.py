"""Serving: the slot-batched engine and its load generators."""
