"""Sequence parallelism: ring attention (context parallelism) and the
Ulysses all-to-all, over the ``seq`` shards of ``utils.groups``."""
