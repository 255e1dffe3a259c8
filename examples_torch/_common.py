"""What the examples share: the command line (sizes as positional
arguments, ``--device``, ``--out``) and the device."""

from __future__ import annotations

import argparse
import tempfile

import torch


def parse(argv, doc: str, sizes, out_name: str | None = None):
    """``sizes``: ``(name, type, default, help)`` of the optional
    positional size arguments, in order. Adds ``--device`` (default: the
    CUDA card; "cpu" runs the plain twins) and, with ``out_name``,
    ``--out`` (default: ``out_name`` in the temporary directory)."""
    ap = argparse.ArgumentParser(description=doc.strip().split("\n\n")[0])
    for name, typ, default, help_ in sizes:
        ap.add_argument(name, nargs="?", type=typ, default=default,
                        help=f"{help_} (default {default})")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain twins)")
    if out_name is not None:
        ap.add_argument("--out", default=None,
                        help=f"output (default: {out_name} in the "
                             "temporary directory)")
    args = ap.parse_args(argv)
    args.device = device(args.device)
    if out_name is not None and args.out is None:
        args.out = f"{tempfile.gettempdir()}/{out_name}"
    return args


def device(name: str | None) -> torch.device:
    """``name``, or the CUDA card; exits when the card is asked for and
    absent (no fallback to the CPU)."""
    dev = torch.device(name or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card: pass --device cpu to run on the CPU")
    return dev


def generator(dev: torch.device, seed: int) -> torch.Generator:
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
