"""Counterpart of the JAX package's `core` subpackage."""
