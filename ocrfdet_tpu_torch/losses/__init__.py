"""The training losses (counterpart of the JAX package's `losses`)."""
