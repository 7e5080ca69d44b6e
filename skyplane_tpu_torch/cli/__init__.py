"""The port's command line (``python -m skyplane_tpu_torch.cli.cli``)."""
