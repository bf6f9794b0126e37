"""Channel-in-the-loop training curves, the scenario sweep, and their
result tables."""
