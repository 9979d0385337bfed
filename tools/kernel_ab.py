#!/usr/bin/env python3
"""Time kernels 1 and 3 of several checkouts on the same card, each run in
a fresh process, in the order given (for example A B C C B A).

    python3 tools/kernel_ab.py build/parent . build/nosplit \
        build/nosplit . build/parent

Each run builds the kernels of its own checkout (``phase_build``: the
build seconds of each library are printed) and runs ``chip_smoke.py``'s
``phase_ragged`` and ``phase_paged`` (CUDA events, L2 flushed), keeping
the rows of every dtype mix at all_decode, chunk_over_ctx, long_decode
and verify_k8 (kernel 1) and the bf16 rows of kernel 3.  A checkout is a
directory holding ``chip_smoke.py`` and ``tpulab_torch/`` (the parent
commit unpacked with ``git archive``, or this one).  The summary prints
each row's milliseconds run by run, with the card's name and power limit.
Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RUN = r"""
import io, json, sys, contextlib, torch
sys.path.insert(0, '.')
import chip_smoke as c
torch.backends.cuda.matmul.allow_tf32 = False
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    c.phase_build()
    t = c.Timer(torch)
    r = c.phase_ragged(torch, t)
    p = c.phase_paged(torch, t)
build = [line for line in buf.getvalue().splitlines()
         if line.startswith('build:')]
rows = {f"ragged {x['case']} {x['dtypes']}": x['ms'] for x in r
        if x['case'] in ('all_decode', 'verify_k8', 'chunk_over_ctx',
                         'long_decode')}
rows.update({f"paged {x['case']} {x['dtypes']}": x['ms'] for x in p
             if x['dtypes'] == 'bf16/bf16'})
print('AB ' + json.dumps({'build': build, 'rows': rows}), flush=True)
"""


def main(argv=None) -> int:
    dirs = sys.argv[1:] if argv is None else argv
    if not dirs:
        raise SystemExit(__doc__)
    sys.path.insert(0, REPO)
    from tpulab_torch.cuda.platform import card_name_and_power_limit

    res = []
    for i, d in enumerate(dirs):
        out = subprocess.run([sys.executable, "-c", RUN], cwd=d,
                             capture_output=True, text=True, timeout=900)
        line = [x for x in out.stdout.splitlines() if x.startswith("AB ")]
        if out.returncode != 0 or not line:
            raise SystemExit(f"run {i} in {d} failed:\n{out.stderr[-3000:]}")
        rec = json.loads(line[0][3:])
        res.append((d, rec["rows"]))
        print(f"run {i} {d}: " + "; ".join(rec["build"]), flush=True)
    for key in sorted(res[0][1]):
        print(f"{key}: " + " | ".join(f"{d} {rows[key]:.4f}"
                                      for d, rows in res))
    print(card_name_and_power_limit(0), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
