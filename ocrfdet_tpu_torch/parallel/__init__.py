"""Counterpart of the JAX package's `parallel` subpackage: the `data`
axis of the device mesh as a `torch.distributed` process group, one
process per card."""
