#!/usr/bin/env python3
"""Compare ways of returning the execution token on the port's Infer path,
on one CUDA card.

    python3 tools/infer_poller_ab.py      # from the repository root

The pipeline's :class:`tpulab_torch.cuda.sync.EventPoller` returns a
request's execution token once its forward's done event completes.  This
script serves ResNet-50 (224, uint8 input, bf16, ``max_batch_size=128``,
``max_exec_concurrency=4``) through ``InferBench.run`` with three
pollers, swapped in before ``update_resources``:

- ``block``: the package's poller (fires what ``query()`` finds done,
  then blocks in ``synchronize()`` on the oldest pending event);
- ``spin500``: tpulab's design, ``query()`` every event, sleep 0.5 ms
  when none completed;
- ``spin200``: the same with a 0.2 ms sleep.

Batches 1, 8 and 128, ``ROUNDS`` rounds, the pollers in a rotated order
each round, one manager per poller (built once); prints images/s per run
and the median per poller, with the card's name and power limit.
"""

from __future__ import annotations

import os
import statistics
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ROUNDS = 3
BATCHES = (1, 8, 128)
SECONDS = 1.5


def spin_poller(interval_s: float):
    """tpulab's poll loop over torch.cuda events."""
    from tpulab_torch.cuda.sync import EventPoller

    class SpinPoller(EventPoller):
        def _run(self) -> None:
            while True:
                with self._cv:
                    while not self._entries and not self._shutdown:
                        self._cv.wait()
                    entries = list(self._entries)
                    self._entries.clear()
                    stopping = self._shutdown
                if stopping:
                    for _event, cb in entries:
                        self._fire(cb)
                    return
                waiting, fired = [], 0
                for event, cb in entries:
                    if self._ready(event):
                        self._fire(cb)
                        fired += 1
                    else:
                        waiting.append((event, cb))
                if waiting:
                    with self._cv:
                        self._entries.extendleft(reversed(waiting))
                if not fired:
                    time.sleep(interval_s)

    return SpinPoller


def main() -> int:
    if not torch.cuda.is_available():
        print("infer_poller_ab: no CUDA device", file=sys.stderr)
        return 2
    import tpulab_torch
    from tpulab_torch.cuda.platform import card_name_and_power_limit
    from tpulab_torch.cuda.sync import EventPoller
    from tpulab_torch.engine import inference_manager as im
    from tpulab_torch.engine.infer_bench import InferBench
    from tpulab_torch.models import build_model

    torch.backends.cudnn.benchmark = False
    card = card_name_and_power_limit(0)
    print(card, flush=True)
    model = build_model("resnet50", max_batch_size=128, input_dtype=np.uint8)
    pollers = {"block": EventPoller, "spin500": spin_poller(5e-4),
               "spin200": spin_poller(2e-4)}
    managers = {}
    for name, cls in pollers.items():
        im.EventPoller = cls
        mgr = tpulab_torch.InferenceManager(max_exec_concurrency=4)
        mgr.register_model("rn50", model)
        mgr.update_resources()
        managers[name] = mgr
    im.EventPoller = EventPoller
    runs = {(n, b): [] for n in pollers for b in BATCHES}
    order = list(pollers)
    for r in range(ROUNDS):
        for b in BATCHES:
            for name in order[r % len(order):] + order[:r % len(order)]:
                res = InferBench(managers[name]).run(
                    "rn50", batch_size=b, seconds=SECONDS, warmup=4)
                runs[(name, b)].append(res["inferences_per_second"])
                print(f"round {r} batch {b} {name}: "
                      f"{res['inferences_per_second']:.1f} images/s",
                      flush=True)
    for b in BATCHES:
        print(f"batch {b}: " + ", ".join(
            f"{n} median {statistics.median(runs[(n, b)]):.1f} "
            f"({', '.join(f'{v:.1f}' for v in runs[(n, b)])})"
            for n in pollers) + f" images/s [{card}]", flush=True)
    for mgr in managers.values():
        mgr.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
