"""Runners of the JAX package's tutorial and demo scripts, on the port.

One module a script: ``docs/tutorials/01_ngem.py`` … ``07_*.py`` run as
``t01_ngem`` … ``t07_*`` (a module name cannot start with a digit),
``a1``-``a3``, ``z01`` and the two demos keep their names. Each has
``main(device="cuda", fast=False)``, prints its script's headline line
and runs as::

    python -m mlqem_tpu_torch.tutorials.t01_ngem [--fast] [--device cpu]

``fast`` is a smoke size, at most the script's ``MLQEM_TUT_FAST=1``
size: enough to print the headline.
"""
import argparse
from typing import Callable


def run(main: Callable) -> None:
    """Parse ``--fast`` and ``--device`` and call ``main`` with them."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true",
                    help="the reduced smoke-test size")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(device=args.device, fast=args.fast)
