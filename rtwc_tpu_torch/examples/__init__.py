"""Runnable examples of the port (`python -m rtwc_tpu_torch.examples.<name>`)."""
