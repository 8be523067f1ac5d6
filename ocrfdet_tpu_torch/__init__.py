"""OcRFDet in PyTorch for NVIDIA Hopper: the port of `ocrfdet_tpu`.

The JAX package `ocrfdet_tpu` is the reference; this package imports
nothing of it and no JAX. It keeps the JAX package's layout, so every
module here has its counterpart at the same path there. Tensor
functions (ops, geometry, decode) and the detector's batch and outputs
keep the JAX channel-last layouts; the `nn.Module`s run NCHW inside.
Its Pallas kernels become hand-written CUDA kernels (`csrc/`, built by
`kernels.py`), each with a plain PyTorch version beside it that runs
for CPU tensors.

Ported so far: the eval forward of the flagship
`ocrfdet_config(batch_size=1)` with the OcRF branch and HOA, and of its
`with_ocrf=False` slice, with host NMS (see `entry.py`).
"""
