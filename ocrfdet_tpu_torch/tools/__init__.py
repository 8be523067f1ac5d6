"""Command-line tools of the port, run as modules:
`python -m ocrfdet_tpu_torch.tools.{train,eval,overfit}`."""
