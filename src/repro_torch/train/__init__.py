"""Train-step construction."""
