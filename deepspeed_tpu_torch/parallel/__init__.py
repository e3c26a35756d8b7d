"""Tensor-parallel building blocks (mirrors ``deepspeed_tpu/parallel``):
the serving collectives (``collectives.py``) and the logical-axis sharding
rules (``sharding.py``)."""
