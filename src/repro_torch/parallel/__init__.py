"""The port's multi-rank machinery: collectives and rank processes
(``comm``) and the GPipe schedule (``pipeline``)."""
