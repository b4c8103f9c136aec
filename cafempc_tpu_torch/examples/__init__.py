"""Runnable examples of the port: `python -m cafempc_tpu_torch.examples.<name>`."""
