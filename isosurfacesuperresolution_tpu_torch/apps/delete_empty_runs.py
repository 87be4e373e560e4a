"""Run-directory cleanup: delete runs without checkpoints.

Counterpart of the JAX package's `apps/delete_empty_runs.py`
(`DeleteEmptyRuns.py`): removes the ``runNNNNN`` directories that never
wrote a checkpoint (crashed or aborted runs).  A run counts as having one
when its ``checkpoints/`` holds an all-digit entry (an orbax step) or one
of the port's own ``epoch_<N>.pt`` files.

Usage:
  python -m isosurfacesuperresolution_tpu_torch.apps.delete_empty_runs \\
      runs [--dryRun]
"""

from __future__ import annotations

import argparse
import os
import re
import shutil

_RUN = re.compile(r"^run\d{5}$")
_EPOCH = re.compile(r"^epoch_\d+\.pt$")


def find_empty_runs(base: str):
    """The ``runNNNNN`` directories under ``base`` without a checkpoint,
    in sorted order."""
    empty = []
    for name in sorted(os.listdir(base)):
        if not _RUN.match(name):
            continue
        run = os.path.join(base, name)
        ckpt = os.path.join(run, "checkpoints")
        has_ckpt = os.path.isdir(ckpt) and any(
            e.isdigit() or _EPOCH.match(e) for e in os.listdir(ckpt))
        if not has_ckpt:
            empty.append(run)
    return empty


def main(argv=None):
    """Returns the runs deleted (or, with ``--dryRun``, to delete)."""
    p = argparse.ArgumentParser()
    p.add_argument("base", nargs="?", default="runs")
    p.add_argument("--dryRun", action="store_true")
    args = p.parse_args(argv)
    if not os.path.isdir(args.base):
        raise SystemExit(f"no such directory: {args.base}")
    empty = find_empty_runs(args.base)
    for run in empty:
        if args.dryRun:
            print("would delete", run)
        else:
            shutil.rmtree(run)
            print("deleted", run)
    if not empty:
        print("no empty runs found")
    return empty


if __name__ == "__main__":
    main()
