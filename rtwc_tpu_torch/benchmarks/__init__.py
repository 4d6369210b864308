"""Benchmarks of the port (`python -m rtwc_tpu_torch.benchmarks.<name>`)."""
