"""The port's multi-rank machinery: collectives and rank processes
(``comm``), logical-axis sharding of the model's leaves (``sharding``) and
the GPipe schedule (``pipeline``)."""
