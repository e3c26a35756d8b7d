"""Model injection for the port: the JAX-to-torch weights bridge."""

from .from_jax import params_from_numpy  # noqa: F401
