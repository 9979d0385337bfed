"""The port's process-group helpers across real processes, on the CPU.

tpulab's ``tests/test_multihost.py`` starts two ``jax.distributed``
processes, and its CPU backend rejects multi-process computations, so it
accepts a skip.  gloo runs the collectives, so the port's two ranks
(spawned, a ``FileStore`` under the test's temporary directory, joined
within 120 s) cross the barrier for real and each computes tpulab's
``local_data_slice`` for a 5-row batch: rows [0, 3) and [3, 5).  Then
the dry run, ``python -m tpulab_torch.parallel.dryrun --nproc 4 --device
cpu``, as a subprocess: every line of tpulab's sequence, each part held
against its single-device form inside the run.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tpulab_torch.parallel import multihost

REPO = Path(__file__).resolve().parents[1]


def _two_ranks(rank, world, store, out_dir):
    import torch.distributed as dist

    multihost.initialize(f"file://{store}", world, rank, device="cpu")
    multihost.initialize(f"file://{store}.unused", world, rank,
                         device="cpu")          # idempotent: a no-op
    mesh = multihost.global_mesh()
    assert multihost.supports_multiprocess_collectives(mesh)
    multihost.barrier(mesh)         # returns only when BOTH ranks arrive
    lo, hi = multihost.local_data_slice(5, mesh)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             slice=np.array([lo, hi]), world=dist.get_world_size(),
             backend=dist.get_backend(),
             mesh=np.array(list(mesh.shape)),
             names=np.array(list(mesh.mesh_dim_names)),
             no_mesh=np.array(multihost.local_data_slice(5)))


def test_two_process_barrier_and_data_slices(tmp_path):
    multihost.launch(_two_ranks, 2, (2, str(tmp_path / "store"),
                                     str(tmp_path)), timeout=120)
    res = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    for r in res:
        assert int(r["world"]) == 2 and str(r["backend"]) == "gloo"
        assert list(r["mesh"]) == [2, 1]
        assert list(r["names"]) == ["data", "model"]
    # the 5-row global batch splits 3 / 2 across the two ranks
    assert list(res[0]["slice"]) == [0, 3] and list(res[1]["slice"]) == [3, 5]
    assert list(res[0]["no_mesh"]) == [0, 3]
    assert list(res[1]["no_mesh"]) == [3, 5]


def _fails(rank, world):
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")


def test_launch_reports_a_failed_rank():
    with pytest.raises(RuntimeError, match=r"ranks failed .*\{1: 1\}"):
        multihost.launch(_fails, 2, (2,), timeout=120)


def test_initialize_checks_its_arguments():
    """Checked before any group opens (this process opens none)."""
    with pytest.raises(ValueError, match="go together"):
        multihost.initialize("127.0.0.1:1", device="cpu")
    with pytest.raises(ValueError, match="host:port"):
        multihost.initialize("no-port", 2, 0, device="cpu")
    assert multihost.local_data_slice(5) == (0, 5)   # one process
    assert multihost.supports_multiprocess_collectives()


def _dryrun(*args):
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    return subprocess.run([sys.executable, "-m", "tpulab_torch.parallel.dryrun",
                           *args], capture_output=True, text=True,
                          timeout=240, env=env, cwd=REPO)


def test_dryrun_four_cpu_ranks():
    out = _dryrun("--nproc", "4", "--device", "cpu", "--timeout", "120")
    assert out.returncode == 0, out.stderr[-3000:]
    for want in ("dryrun train step ok on 4 devices (mesh data=2 model=2",
                 "dryrun sharded inference ok",
                 "dryrun ring-attention (sp=4) ok",
                 "dryrun expert-parallel MoE (ep=4) ok",
                 "dryrun pipeline (pp=4) ok",
                 "dryrun paged sharded decode ok (mesh model=2): "
                 "parity=True"):
        assert want in out.stdout, (want, out.stdout)


def test_dryrun_on_the_card_refuses_without_one():
    """The port never routes to the CPU by itself: the default device is
    the card, and here there is none (raised before any rank starts)."""
    from tpulab_torch.parallel import dryrun

    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--nproc", "2"])
