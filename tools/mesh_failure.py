#!/usr/bin/env python3
"""Plant a fault in a follower of a ``{"model": N}`` mesh and time how the
coordinator's requests fail (one process per card, NCCL).

    python tools/mesh_failure.py --nproc 4
    python tools/mesh_failure.py --nproc 4 --device cpu       # gloo

Every rank opens the group, builds ``make_mesh({"model": N})``, cuts its
shards of a small model (d_model 256, 4 query and 4 KV heads, 2 layers,
bf16 on the cards; ``init_transformer_shards``) and constructs the same
ragged-plan ``ContinuousBatcher`` (2 lanes).  The last rank's first
decode block raises, ``--when after`` its collectives or ``before`` them
(``tests/test_torch_sharded_decode.py::test_follower_failure_fails_the_mesh``
plants the same fault on gloo).  The coordinator submits three requests
(two lanes busy, one queued) and records how each future ends and after
how many seconds, then one more submit.  Passes when every future raises
``MeshFailure`` within ``--deadline`` seconds (well inside the groups'
600 s collective timeout), the later submit raises, and every rank
records the failure; prints one JSON line and exits non-zero otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = dict(vocab=512, d_model=256, n_heads=4, n_kv_heads=4, d_ff=512,
             n_layers=2)


def _rank(rank, nproc, store, out_dir, args):
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    from tpulab_torch.engine.paged import ContinuousBatcher
    from tpulab_torch.engine.sharded import init_transformer_shards
    from tpulab_torch.parallel import make_mesh, multihost

    cpu = args["device"] == "cpu"
    multihost.initialize(f"file://{store}", nproc, rank,
                         device="cpu" if cpu else None)
    mesh = make_mesh({"model": nproc})
    dtype = torch.float32 if cpu else torch.bfloat16
    params = init_transformer_shards(mesh, **MODEL, dtype=dtype)
    when = args["when"]
    if rank == nproc - 1:
        block = ContinuousBatcher._op_block

        def faulty(self, *a, **kw):
            if when == "after":
                block(self, *a, **kw)
            raise RuntimeError(f"planted fault {when} the block")
        ContinuousBatcher._op_block = faulty
    cb = ContinuousBatcher(params, n_heads=MODEL["n_heads"],
                           n_layers=MODEL["n_layers"],
                           n_kv_heads=MODEL["n_kv_heads"], lanes=2,
                           max_len=64, page_size=16, compute_dtype=dtype,
                           mesh=mesh, ragged=True)
    out = {"rank": rank}
    try:
        if cb.is_coordinator:
            rng = np.random.default_rng(0)
            t0 = time.perf_counter()
            futs = [cb.submit(rng.integers(0, MODEL["vocab"], (n,),
                                           np.int32), 16)
                    for n in (12, 7, 9)]
            ends = []
            for f in futs:
                try:
                    ends.append(["tokens", len(f.result(
                        timeout=args["deadline"]))])
                except Exception as e:  # noqa: BLE001 - the outcome
                    ends.append([type(e).__name__, str(e)[:200]])
                ends[-1].append(time.perf_counter() - t0)
            out["futures"] = ends
            try:
                cb.submit(np.ones(4, np.int32), 2)
                out["submit_after"] = "accepted"
            except Exception as e:  # noqa: BLE001
                out["submit_after"] = type(e).__name__
    finally:
        # written before and after the shutdown (a follower's replay, and
        # its failure, end there): a shutdown that hangs still leaves the
        # outcomes
        for stage in ("before_shutdown", "after_shutdown"):
            if stage == "after_shutdown":
                cb.shutdown()
            out["failure"], out["stage"] = cb.mesh_failure, stage
            with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
                json.dump(out, f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--when", choices=("after", "before"), default="after")
    ap.add_argument("--deadline", type=float, default=120.0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    from tpulab_torch.parallel.multihost import launch

    if a.device == "cuda":
        import torch
        have = torch.cuda.device_count()
        if a.nproc > have:
            raise RuntimeError(f"need {a.nproc} devices, have {have}")
    args = dict(when=a.when, deadline=a.deadline, device=a.device)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        error = None
        try:
            launch(_rank, a.nproc, (a.nproc, os.path.join(d, "store"), d,
                                    args), timeout=a.deadline + 120)
        except Exception as e:  # noqa: BLE001 - reported with the ranks
            error = f"{type(e).__name__}: {e}"
        ranks = []
        for r in range(a.nproc):
            path = os.path.join(d, f"rank{r}.json")
            if os.path.exists(path):
                with open(path) as f:
                    ranks.append(json.load(f))
    coord = next((r for r in ranks if "futures" in r), {})
    futs = coord.get("futures", [])
    ok = (len(futs) == 3
          and all(k == "MeshFailure" and s < a.deadline for k, _, s in futs)
          and coord.get("submit_after") == "MeshFailure"
          and len(ranks) == a.nproc
          and all(r["failure"] and r["stage"] == "after_shutdown"
                  for r in ranks))
    print(json.dumps({"ok": ok, "nproc": a.nproc, **args,
                      "launch_error": error,
                      "wall_s": time.perf_counter() - t0, "ranks": ranks}),
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
