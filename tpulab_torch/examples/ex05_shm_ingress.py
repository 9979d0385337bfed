"""Zero-copy shared-memory ingress (reference examples/02's SysV shm input
path, server.cc:110-137: clients place tensor bytes in shared memory; the
server binds them without a socket copy).

Run as one command — it spawns the producer as a child process (the port
of tpulab's ``examples/05_shm_ingress.py``):

    python -m tpulab_torch.examples.ex05_shm_ingress [--device cpu]
"""

import subprocess
import sys

import numpy as np

from tpulab_torch.examples._device import add_device_arg


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    add_device_arg(ap)
    device = ap.parse_args(argv).device
    from tpulab_torch.engine import InferenceManager
    from tpulab_torch.memory.allocator import make_allocator
    from tpulab_torch.memory.shm import SharedMemoryAllocator
    from tpulab_torch.models import build_model

    # serving process owns a shared staging segment
    shm_raw = SharedMemoryAllocator(prefix="tpulab_torch_demo")
    alloc = make_allocator(shm_raw)
    desc = alloc.allocate_descriptor(28 * 28 * 4, 64)
    segment = shm_raw.segment_name(desc.addr)
    print(f"server segment: {segment}")

    # a separate PRODUCER process fills the segment (no socket, no copy)
    producer = (
        "import numpy as np\n"
        "from tpulab_torch.memory.shm import SharedMemoryAllocator\n"
        f"seg = SharedMemoryAllocator.attach('{segment}')\n"
        "arr = seg.numpy(np.float32, (28, 28))\n"
        "arr[:] = np.fromfunction(lambda i, j: (i + j) / 56.0, (28, 28))\n"
        "seg.close()\n"
        "print('producer: wrote 28x28 image into shared memory')\n"
    )
    subprocess.run([sys.executable, "-c", producer], check=True, timeout=120)

    # the server binds the SAME memory as the model input — zero-copy ingress
    mgr = InferenceManager(max_executions=1, device=device)
    mgr.register_model("mnist", build_model("mnist", max_batch_size=1,
                                            device=device))
    mgr.update_resources()
    image = desc.numpy(np.float32, (1, 28, 28, 1))
    out = mgr.infer_runner("mnist").infer(Input3=image).result(timeout=120)
    print(f"served from shm: logits {out['Plus214_Output_0'].shape}, "
          f"argmax {int(out['Plus214_Output_0'].argmax())}")
    mgr.shutdown()
    desc.release()
    shm_raw.close()


if __name__ == "__main__":
    main()
