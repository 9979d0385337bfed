#!/usr/bin/env python3
"""Serve one model over several cards: tensor-parallel paged decoding
with ``tpulab_torch`` (one process per card, NCCL).

    python tools/sharded_serve.py --nproc 4 --model llama3-70b
    python tools/sharded_serve.py --nproc 2 --model llama3-70b --int8
    python tools/sharded_serve.py --nproc 2 --model tiny --device cpu

Spawns ``--nproc`` ranks on this host (``multihost.launch``; NCCL with one
card a rank, gloo with ``--device cpu``).  Every rank opens the group,
builds ``make_mesh({"model": N})``, cuts its Megatron shards of the
model's random weights leaf by leaf on its own device
(``init_transformer_shards``: no rank holds the whole tree) and runs
``benchmark_sharded_decode(single=False)``: ``--lanes`` requests of
``--prompt`` tokens x ``--steps`` served twice on the mesh after a
warm-up, then one device-sampled request.  Printed: the row (tok/s, the
coordinator's busy share of the second timed run, under a profiler,
host syncs per dispatch, the second run's token parity), and per rank its kernel 1 launches
against ``n_layers`` x the coordinator's forward steps, its peak device
memory and its card's name and power limit.  ``--int8`` serves the
weight-only int8 tree instead (each projection quantized whole on its
rank's card, then cut by its parent's rule: Llama-3-70B's about 70 GB
over two cards).  Exits non-zero when a check fails.  ``--out`` also
writes the result as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the ranks' deadline (a 70B serve over four H100s took about 400 s)
TIMEOUT_S = 1800.0

#: widths from each model's published config.json (random bf16 weights)
MODELS = {
    # meta-llama/Meta-Llama-3-70B
    "llama3-70b": dict(vocab=128256, d_model=8192, n_heads=64, n_kv_heads=8,
                       d_ff=28672, n_layers=80, rope_theta=500000.0),
    # a CPU-sized rehearsal of the same code path
    "tiny": dict(vocab=512, d_model=256, n_heads=4, n_kv_heads=4, d_ff=512,
                 n_layers=2, rope_theta=500000.0),
}


def _rank(rank, nproc, store, out_dir, args):
    sys.path.insert(0, REPO)
    import torch

    from tpulab_torch.engine.sharded import benchmark_sharded_decode
    from tpulab_torch.ops.ragged_attention import ragged_paged_attention
    from tpulab_torch.parallel import make_mesh, multihost

    torch.backends.cuda.matmul.allow_tf32 = False
    device = "cpu" if args["device"] == "cpu" else None
    multihost.initialize(f"file://{store}", nproc, rank, device=device)
    mesh = make_mesh({"model": nproc})
    m = MODELS[args["model"]]
    dtype = torch.float32 if args["device"] == "cpu" else torch.bfloat16
    ragged_paged_attention.launches = 0
    row = benchmark_sharded_decode(
        model_shards=nproc, lanes=args["lanes"], steps=args["steps"],
        prompt_len=args["prompt"], d_model=m["d_model"],
        n_heads=m["n_heads"], n_kv_heads=m["n_kv_heads"],
        n_layers=m["n_layers"], vocab=m["vocab"], d_ff=m["d_ff"],
        ffn="swiglu", tie_embeddings=False, rope_theta=m["rope_theta"],
        decode_block=8, page_size=16, max_len=args["max_len"],
        dtype=dtype, single=False, mesh=mesh, quantize=args["int8"])
    res = {"rank": rank, "launches": ragged_paged_attention.launches,
           "row": row}
    if torch.cuda.is_available() and device is None:
        from tpulab_torch.cuda.platform import card_name_and_power_limit
        idx = torch.cuda.current_device()
        res["peak_gb"] = torch.cuda.max_memory_allocated(idx) / 1e9
        res["card"] = card_name_and_power_limit(idx)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--model", choices=sorted(MODELS), default="llama3-70b")
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--max-len", type=int, default=2048)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--int8", action="store_true",
                    help="serve the weight-only int8 tree")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    from tpulab_torch.parallel.multihost import launch

    if a.device == "cuda":
        import torch
        have = torch.cuda.device_count()
        if a.nproc > have:
            raise RuntimeError(f"need {a.nproc} devices, have {have}")
    args = dict(model=a.model, lanes=a.lanes, prompt=a.prompt,
                steps=a.steps, max_len=a.max_len, device=a.device,
                int8=a.int8)
    with tempfile.TemporaryDirectory() as d:
        launch(_rank, a.nproc, (a.nproc, os.path.join(d, "store"), d, args),
               timeout=TIMEOUT_S)
        ranks = []
        for r in range(a.nproc):
            with open(os.path.join(d, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    row = ranks[0]["row"]
    n_layers = MODELS[a.model]["n_layers"]
    steps = sum(row[m]["forward_steps_total"] for m in ("sharded", "again"))
    print(json.dumps({"model": a.model, "nproc": a.nproc, **args,
                      "row": row}), flush=True)
    ok = row["repeat_parity"] and row["repeat_sampled_parity"] \
        and row["one_sync_per_dispatch"]
    for r in ranks:
        if a.device == "cpu":      # the plain version counts no launch
            print(f"rank {r['rank']}: the plain attention on the CPU "
                  f"({n_layers} x {steps} forward steps)", flush=True)
            continue
        good = r["launches"] == n_layers * steps
        ok &= good
        print(f"rank {r['rank']}: kernel 1 launches {r['launches']} "
              f"{'==' if good else '!='} {n_layers} x {steps} forward "
              f"steps; peak {r['peak_gb']:.2f} GB [{r['card']}]",
              flush=True)
    busy = row["again"]["busy"]
    print(f"sharded serve {'ok' if ok else 'FAILED'}: {a.model} over "
          f"{a.nproc} ranks, {row['sharded']['tok_s']:.1f} tok/s (second "
          f"run{'' if busy is None else ', profiled'}: "
          f"{row['again']['tok_s']:.1f} tok/s, coordinator busy "
          f"{'not measured' if busy is None else f'{busy:.3f}'}), "
          f"repeat parity {row['repeat_parity']}", flush=True)
    if a.out:
        with open(a.out, "w") as f:
            json.dump({"args": args, "ranks": ranks}, f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
