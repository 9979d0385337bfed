"""The ``--device`` flag every example takes in place of tpulab's
``--cpu``: ``None`` (the default) is the CUDA card, ``cpu`` the host."""

from __future__ import annotations

import argparse
import sys


def add_device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the CUDA "
                         "card; 'cpu' runs on the host)")


def notebook_device(argv=None):
    """A walkthrough's device from ``--device`` on its command line (the
    walkthroughs take no other flag)."""
    ap = argparse.ArgumentParser()
    add_device_arg(ap)
    return ap.parse_known_args(sys.argv[1:] if argv is None else argv)[0] \
        .device
