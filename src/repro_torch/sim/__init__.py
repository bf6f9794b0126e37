"""Channel-in-the-loop training curves and their result tables."""
