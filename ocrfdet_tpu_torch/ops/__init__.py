"""Counterpart of the JAX package's `ops` subpackage.

Importing it registers the kernels' custom ops (`torch.ops.ocrfdet.*`),
which a saved `torch.export` program needs before it loads."""
from . import bev_pool, cost_volume, ht_pool, nms, point_sample  # noqa: F401
from .splat import composite  # noqa: F401
