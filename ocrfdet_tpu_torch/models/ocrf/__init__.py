"""The OcRF branch (counterpart of ocrfdet_tpu/models/ocrf/)."""
