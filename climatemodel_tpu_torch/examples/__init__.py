"""The JAX package's example scripts (``examples/``), in the port.

Each script keeps its JAX name and its ``run_*`` function with the same
parameters, plus ``device`` (the card unless the caller names another) and
``dtype``.  Importing a script runs nothing: its work sits in ``main()``
behind ``if __name__ == '__main__'``::

    python -m climatemodel_tpu_torch.examples.<name> --device cuda

Figures and animations go to ``out_dir``, by default ``build/examples/`` at
the repository root (git-ignored), never into the JAX package's
``examples/``.  matplotlib is imported only where a figure is drawn, so a
run with its figures turned off needs none.

The scripts live in a subpackage, not beside the JAX ones, so that a test
importing the JAX scripts by bare module name never meets a same-named port
script in ``sys.modules``.
"""
from __future__ import annotations

import argparse
import os
from pathlib import Path

import torch

#: where the scripts write their figures unless told otherwise (git-ignored)
OUT_DIR = Path(__file__).resolve().parents[2] / 'build' / 'examples'

_DTYPES = {'float32': torch.float32, 'float64': torch.float64}


def out_path(out_dir, name):
    """``out_dir / name`` (``out_dir`` None: :data:`OUT_DIR`), the folder
    made if missing."""
    folder = Path(out_dir) if out_dir is not None else OUT_DIR
    folder.mkdir(parents=True, exist_ok=True)
    return str(folder / name)


def pyplot():
    """matplotlib's pyplot, on the Agg backend where there is no display."""
    import matplotlib
    if os.environ.get('DISPLAY', '') == '':
        matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    return plt


def say_fn(verbose):
    return print if verbose else (lambda *a, **k: None)


def parse_args(description, argv=None):
    """The scripts' command line: ``--device`` (default ``cuda``),
    ``--dtype`` (float32 or float64), ``--out-dir`` and ``--no-figures``
    (``args.figures`` False: nothing drawn, no matplotlib needed)."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument('--device', default='cuda',
                    help="torch device to run on (default 'cuda')")
    ap.add_argument('--dtype', default='float32', choices=sorted(_DTYPES))
    ap.add_argument('--out-dir', default=None,
                    help=f'folder for the figures (default {OUT_DIR})')
    ap.add_argument('--no-figures', dest='figures', action='store_false',
                    help='run without drawing (no matplotlib needed)')
    args = ap.parse_args(argv)
    args.dtype = _DTYPES[args.dtype]
    return args
