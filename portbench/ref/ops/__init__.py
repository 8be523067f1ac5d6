"""Counterpart of the JAX package's `ops` subpackage: the plain versions
of the kernels that an eval forward runs (K1-K4) and the host NMS."""
from . import bev_pool, cost_volume, ht_pool, point_sample  # noqa: F401
