"""The traffic drivers: each traffic file names one under `driver`."""
