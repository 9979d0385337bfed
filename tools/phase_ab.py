#!/usr/bin/env python3
"""Time one ``chip_smoke.py`` phase of two checkouts on the same card, in
alternating order (A B B A), each run in a fresh process.

    python3 tools/phase_ab.py --base build/parent --phase serve \
        --out chiprun_out/ab

A is the checkout at ``--base`` (e.g. the parent commit unpacked with
``git archive``), B this one.  Each run builds the kernels of its own
checkout (``phase_build``), sets TF32 off as ``chip_smoke.py`` does, runs
``phase_<name>(torch, card)`` and prints the phase's wall time.  Every
run's whole output goes to ``<out>/<n>_<A|B>.txt``; the summary printed
here holds each run's phase time and its lines that end in seconds or
hold tok/s, so the phases' parts can be compared side by side.  The card's
name and power limit are printed with it.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RUN = """
import sys, time, torch
sys.path.insert(0, '.')
import chip_smoke as c
from tpulab_torch.cuda.platform import card_name_and_power_limit
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
card = card_name_and_power_limit(0)
c.phase_build()
t0 = time.perf_counter()
getattr(c, 'phase_' + sys.argv[1])(torch, card)
print(f'phase_ab: {sys.argv[1]} {time.perf_counter() - t0:.1f} s [{card}]',
      flush=True)
"""

#: the lines of a run kept in the summary
KEEP = re.compile(r"( \d+\.\d s$| tok/s|phase_ab: )")


def run_once(where: str, phase: str, path: str, timeout: float) -> list:
    t0 = time.perf_counter()
    with open(path, "w") as f:
        rc = subprocess.run([sys.executable, "-c", RUN, phase], cwd=where,
                            stdout=f, stderr=subprocess.STDOUT,
                            timeout=timeout).returncode
    wall = time.perf_counter() - t0
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f if KEEP.search(ln)]
    if rc:
        raise SystemExit(f"phase_ab: {path} exited {rc}")
    return lines + [f"phase_ab: process {wall:.1f} s"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True,
                    help="checkout A (a directory holding chip_smoke.py)")
    ap.add_argument("--phase", default="serve",
                    help="chip_smoke.phase_<name>(torch, card) to time")
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "phase_ab"))
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds one run may take")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("phase_ab: no CUDA device", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    where = {"A": os.path.abspath(args.base), "B": REPO}
    for i, side in enumerate("ABBA"):
        path = os.path.join(args.out, f"{i + 1}_{side}.txt")
        lines = run_once(where[side], args.phase, path, args.timeout)
        print(f"== run {i + 1}: {side} ({where[side]})")
        for ln in lines:
            print(ln)
        sys.stdout.flush()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
