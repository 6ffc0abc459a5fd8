"""Measurement tools of the port, run as ``python -m touchgs_torch.tools.<name>``."""
