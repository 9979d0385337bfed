"""Python API quickstart (the port of tpulab's ``examples/30_python_api.py``;
reference examples/30_PyTensorRT server.py/client.py + the Quickstart /
Demo Day / Multiple Models notebooks).

Flow: build -> register (x2 models) -> update_resources -> runner.infer ->
serve -> remote manager -> golden check.

    python -m tpulab_torch.examples.ex30_python_api [--device cpu]
"""

import argparse

import numpy as np

import tpulab_torch
from tpulab_torch.examples._device import add_device_arg
from tpulab_torch.models import build_model


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_device_arg(ap)
    device = ap.parse_args(argv).device
    # --- local manager (notebook "Quickstart") ---
    manager = tpulab_torch.InferenceManager(max_exec_concurrency=2,
                                            device=device)
    manager.register_model("mnist_a", build_model("mnist", max_batch_size=4,
                                                  device=device))
    manager.register_model("mnist_b",
                           build_model("mnist", max_batch_size=4, seed=7,
                                       device=device))
    manager.update_resources()

    runner = manager.infer_runner("mnist_a")
    x = np.random.default_rng(0).standard_normal((2, 28, 28, 1)).astype(np.float32)
    future = runner.infer(Input3=x)
    outputs = future.result()                 # InferFuture.get()
    print("local logits:", outputs["Plus214_Output_0"].shape)

    # --- multiple models concurrently (notebook "Multiple Models") ---
    futs = [manager.infer_runner(m).infer(Input3=x)
            for m in ("mnist_a", "mnist_b") for _ in range(4)]
    print("concurrent results:", len([f.result() for f in futs]))

    # --- serve + remote manager (reference server.py/client.py) ---
    manager.serve(port=0)
    remote = tpulab_torch.RemoteInferenceManager(
        f"localhost:{manager.server.bound_port}")
    print("remote models:", sorted(remote.get_models()))
    remote_out = remote.infer_runner("mnist_a").infer(Input3=x).result()
    # golden check (reference run_onnx_tests.py np.testing pattern)
    np.testing.assert_allclose(remote_out["Plus214_Output_0"],
                               outputs["Plus214_Output_0"], rtol=1e-5)
    print("remote == local: OK")
    remote.close()
    manager.shutdown()


if __name__ == "__main__":
    main()
