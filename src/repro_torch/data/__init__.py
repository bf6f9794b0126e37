"""Synthetic datasets (numpy only), copied from the JAX package."""
