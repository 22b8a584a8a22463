"""Command-line entry points of the port, run as
``python -m sonicsim_tpu_torch.scripts.<name>``."""
