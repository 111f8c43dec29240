"""Runnable examples of the port (counterparts of the repository's
``examples/``): ``python -m repro_torch.examples.<name> [--device cpu]``.
They run on the card unless ``--device cpu`` is passed."""

import argparse


def device_arg(description: str):
    """The examples' command line: ``--device`` (default: the card)."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: CUDA; 'cpu' runs the kernels' "
                         "plain PyTorch versions)")
    return ap.parse_args().device
