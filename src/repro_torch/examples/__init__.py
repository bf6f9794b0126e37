"""The JAX package's ``examples/`` on the port: each runs as ``python -m
repro_torch.examples.<name>`` through the port's own entry points
(``vertical`` with ``make_train_step``, ``run_curves``, ``run_sweep``,
``trainer.train``, ``ServeEngine``), on the card unless ``--device cpu``
is given, with its JAX counterpart's arguments, defaults and printed
lines.  ``--steps`` (or ``--rounds``) shortens an example that had no
way to, and ``main(argv)`` returns what it printed for a test to read.
"""
