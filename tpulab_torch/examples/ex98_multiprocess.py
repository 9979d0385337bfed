"""N server processes + round-robin client (the port of tpulab's
``examples/98_multiprocess.sh``; reference examples/98: N processes
sharing a V100 via CUDA MPS + envoy).  Each replica is an
``ex02_inference_service`` process; with several cards replica i is
pinned to card ``i % count`` (``CUDA_VISIBLE_DEVICES``), on a one-card
host they all share it, as the reference's MPS replicas share one GPU.

    python -m tpulab_torch.examples.ex98_multiprocess 2 resnet50

``BASE_PORT`` (default 51000) and ``EXTRA_ARGS`` (e.g. ``--device cpu``
for hermetic runs) are read from the environment, as the script reads
them.
"""

from __future__ import annotations

import os
import shlex
import subprocess
import sys
import threading
import time

import numpy as np

#: requests each replica's closed-loop worker sends
PER = 100


def _visible(i: int, extra) -> dict:
    """Replica i's environment: pinned to card ``i % count`` when the host
    has cards and the replica serves on one."""
    env = dict(os.environ)
    if "--device" in extra and "cpu" in extra:
        return env
    import torch

    n = torch.cuda.device_count()
    if n > 1:
        env["CUDA_VISIBLE_DEVICES"] = str(i % n)
    return env


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if len(argv) > 0 else 2
    model = argv[1] if len(argv) > 1 else "mnist"
    base_port = int(os.environ.get("BASE_PORT", "51000"))
    extra = shlex.split(os.environ.get("EXTRA_ARGS", ""))

    from tpulab_torch.rpc.infer_service import RemoteInferenceManager

    procs = []
    try:
        for i in range(n):
            port = base_port + i
            procs.append(subprocess.Popen(
                [sys.executable, "-m",
                 "tpulab_torch.examples.ex02_inference_service",
                 "--model", model, "--port", str(port),
                 "--metrics-port", str(9100 + i), *extra],
                env=_visible(i, extra)))
            print(f"replica {i} on :{port} (pid {procs[-1].pid})",
                  flush=True)

        print("waiting for replicas...", flush=True)
        for i in range(n):
            while True:
                if procs[i].poll() is not None:
                    raise SystemExit(f"replica {i} exited with "
                                     f"{procs[i].returncode}")
                remote = RemoteInferenceManager(f"localhost:{base_port + i}")
                try:
                    remote.get_models()
                    break
                except Exception:
                    time.sleep(2)
                finally:
                    remote.close()

        print(f"driving synchronized load across {n} replicas", flush=True)
        # Coordinated measurement (reference examples/00 infer.cc:85
        # MPI_Barrier): one closed-loop worker per replica, all released
        # from a start-line barrier together, so the aggregate inf/s is a
        # true simultaneous figure rather than a ragged-start mush.
        remotes = [RemoteInferenceManager(f"localhost:{base_port + i}")
                   for i in range(n)]
        runners = [r.infer_runner(model) for r in remotes]
        spec = remotes[0].get_models()[model].inputs[0]
        x = np.zeros((1, *spec.dims), np.dtype(spec.dtype))
        for r in runners:
            r.infer(**{spec.name: x}).result(timeout=300)  # warmup
        start_line = threading.Barrier(n + 1)
        done, errors = [], []

        def worker(runner):
            start_line.wait()  # MPI_Barrier analog
            t0 = time.perf_counter()
            try:
                for _ in range(PER):
                    runner.infer(**{spec.name: x}).result(timeout=300)
            except Exception as e:  # a failed replica fails the benchmark
                errors.append(e)
                return
            done.append(time.perf_counter() - t0)

        threads = [threading.Thread(target=worker, args=(r,))
                   for r in runners]
        [t.start() for t in threads]
        start_line.wait()
        t0 = time.perf_counter()
        [t.join() for t in threads]
        wall = time.perf_counter() - t0
        for r in remotes:
            r.close()
        if errors:
            raise SystemExit(f"{len(errors)}/{n} replicas failed: "
                             f"{errors[0]!r}")
        print(f"{n * PER} requests over {n} replicas (synchronized start): "
              f"{n * PER / wall:.1f} inf/s aggregate; "
              f"slowest replica {max(done):.2f}s fastest {min(done):.2f}s",
              flush=True)
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
    return 0


if __name__ == "__main__":
    sys.exit(main())
