"""The benchmark of the PyTorch and CUDA port `ocrfdet_tpu_torch`."""
