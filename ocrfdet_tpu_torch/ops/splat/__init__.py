"""Gaussian splatting for the OcRF render branch: preprocessing, the tiled
renderer on kernel K5, and the dense reference renderer."""
