"""Counterpart of the JAX package's `models` subpackage."""
