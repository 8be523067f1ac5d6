"""The plain reference of the benchmark: a frozen copy of the port's
plain PyTorch and numpy code (configs, geometry, decode, the eval model),
with every hand-written kernel replaced by the plain version that stood
beside it and the host NMS in numpy alone. Only what the serving cells
run is copied: no training step, losses, renderer, teacher or sharding.

It imports nothing of the program it judges, and it is never edited
with it: later changes to the program leave this copy as it was. The
module docstrings are the originals; where they speak of a kernel, the
plain version runs here.
"""
