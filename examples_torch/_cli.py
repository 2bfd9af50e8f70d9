"""The command line shared by the examples: ``--device`` (the card by
default; the examples raise without one unless ``--device cpu``),
``--smoke`` (tiny shapes and few cycles: a check that the workflow runs,
not of its quality), ``--plot`` (write figures; needs matplotlib) and
``--out`` (where files go)."""

import argparse
import os
import sys

# run from a checkout: the repository's root on the import path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def parse(doc, argv=None, plot=True, flags=None, options=None):
    """The parsed arguments; ``flags`` maps an example's own on/off
    options to their help, ``options`` its valued ones to (type, default,
    help)."""
    p = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    for name, text in (flags or {}).items():
        p.add_argument(f"--{name}", action="store_true", help=text)
    for name, (kind, default, text) in (options or {}).items():
        p.add_argument(f"--{name}", type=kind, default=default, help=text)
    p.add_argument("--device", default="cuda",
                   help='"cuda" (the default) or "cpu"; no fallback')
    p.add_argument("--smoke", action="store_true",
                   help="tiny shapes and few cycles (runs, not quality)")
    if plot:
        p.add_argument("--plot", action="store_true",
                       help="write figures into --out (needs matplotlib)")
    p.add_argument("--out", default=".",
                   help="directory for the files the example writes")
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    return args
