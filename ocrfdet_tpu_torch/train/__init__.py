"""The training step (counterpart of the JAX package's `train` and the
single-device part of `parallel/step.py`)."""
