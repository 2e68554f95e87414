"""``python -m repro_torch.bench``: audit the package (:func:`audit`) and
list its scripts with the first line of each one's description.  Each
script runs as ``python -m repro_torch.bench.NAME``."""
from __future__ import annotations

import importlib
import sys

from . import SCRIPTS, audit


def main() -> int:
    audit()
    for name in SCRIPTS:
        mod = importlib.import_module(f"{__package__}.{name}")
        print(f"{name:26s} {mod.__doc__.strip().splitlines()[0]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
