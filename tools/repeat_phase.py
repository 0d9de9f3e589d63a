#!/usr/bin/env python3
"""Run phases of a checkout's ``chip_smoke.py`` several times, each run in
a process of its own, and report how each run ended: to check a phase
alone, or to measure how often an intermittent crash comes back, and
where (the runs have ``faulthandler`` on, so a crash in native code
prints the Python stack).

    python3 tools/repeat_phase.py [--tree DIR ...] [--phase NAME ...]
                                  [--times N] [--timeout SECONDS]
                                  [--log FILE]

``--phase`` names a function of ``chip_smoke.py`` that takes no
arguments (default ``phase_gmres_trajectory``, phase 15); given more
than once, a run calls them in order in one process (a phase run alone
computes its CPU twin in that process).  ``--log`` appends every run's
whole output to FILE.  Each
``--tree`` is a checkout (default this one, e.g. also a ``git archive``
of the parent unpacked under ``build/``); the trees' runs alternate.
Each run is one line of JSON: the tree, the run, the exit code (a
negative code is the signal that ended it), the seconds and, if it
failed, the last lines of its output.  Needs the card; the first run of
a tree builds the kernels it uses.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run_once(tree: Path, phases: list, timeout: float, log=None) -> dict:
    code = ("import sys; sys.path.insert(0, '.'); import chip_smoke; "
            + "; ".join(f"chip_smoke.{p}()" for p in phases))
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([sys.executable, "-X", "faulthandler", "-c",
                               code], cwd=tree, capture_output=True,
                              text=True, timeout=timeout)
        rc, out = proc.returncode, proc.stdout + proc.stderr
    except subprocess.TimeoutExpired as exc:
        rc, out = "timeout", f"{exc.stdout or ''}{exc.stderr or ''}"
    if log is not None:
        with open(log, "a") as f:
            f.write(f"# {tree} {' '.join(phases)} rc={rc}\n{out}\n")
    return {"rc": rc, "seconds": round(time.perf_counter() - t0, 1),
            "tail": out.strip().splitlines()[-25:] if rc != 0 else []}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, action="append", default=None)
    ap.add_argument("--phase", action="append", default=None)
    ap.add_argument("--times", type=int, default=3)
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--log", default=None)
    opts = ap.parse_args(argv)
    phases = opts.phase or ["phase_gmres_trajectory"]
    trees = [t.resolve() for t in (opts.tree or [ROOT])]
    failed = 0
    for i in range(opts.times):
        for tree in trees:
            got = run_once(tree, phases, opts.timeout, opts.log)
            failed += got["rc"] != 0
            print(json.dumps({"tree": str(tree), "phase": phases,
                              "run": i, **got}), flush=True)
    print(json.dumps({"runs": opts.times * len(trees), "failed": failed}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
