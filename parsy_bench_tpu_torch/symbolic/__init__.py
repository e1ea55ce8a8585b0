"""Supernodal plan emission (jax-free copy of the JAX package's)."""
