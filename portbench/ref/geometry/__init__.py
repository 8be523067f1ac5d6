"""Counterpart of the JAX package's `geometry` subpackage."""
