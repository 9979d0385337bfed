"""NUMA-aware allocation walkthrough (reference examples/10_Internals
internals.cc:57-146: per-socket ThreadPools, socket-local pinned allocations,
device memory stacks, a Pool of socket-local bundles; the port of
tpulab's ``examples/10_internals.py``).

    python -m tpulab_torch.examples.ex10_internals
"""

import numpy as np

import tpulab_torch.memory as tm
from tpulab_torch.core import Pool, ThreadPool
from tpulab_torch.core.affinity import Affinity
from tpulab_torch.memory.raw_allocators import FirstTouchAllocator


def main():
    nodes = Affinity.numa_nodes()
    print(f"topology: {len(nodes)} NUMA node(s)")
    for n in nodes:
        print(f"  node {n.id}: cpus {sorted(n.cpus)[:8]}"
              f"{'...' if len(n.cpus) > 8 else ''}")

    # one ThreadPool pinned per node (reference per-socket pools)
    pools = {n.id: ThreadPool(2, cpus=n.cpus, name=f"node{n.id}")
             for n in nodes if len(n.cpus)}

    # socket-local staging bundles: first-touch from a pinned thread so the
    # pages land on that node (reference per-socket pinned allocations)
    def make_bundle(node_id):
        def build():
            raw = FirstTouchAllocator()
            alloc = tm.make_allocator(raw)
            desc = alloc.allocate_descriptor(tm.string_to_bytes("4MiB"), 4096)
            return {"node": node_id, "descriptor": desc,
                    "view": desc.numpy(np.float32, (1 << 20,))}
        return pools[node_id].enqueue(build).result(timeout=30)

    bundles = [make_bundle(n.id) for n in nodes if n.id in pools]
    bundle_pool = Pool(bundles)
    print(f"bundle pool: {bundle_pool.available} socket-local staging bundles")

    # requests borrow a bundle, fill it on the matching node, return it
    by_id = {n.id: n for n in nodes}  # NUMA ids may be non-contiguous

    def request(i):
        with bundle_pool.pop(timeout=10) as b:
            with ThreadPool(1, cpus=by_id[b["node"]].cpus) as tp:
                tp.enqueue(lambda: b["view"].__setitem__(
                    slice(0, 1024), float(i))).result(timeout=10)
            return b["view"][:4].copy()

    results = [request(i) for i in range(4)]
    print("requests filled node-locally:",
          [float(r[0]) for r in results])
    for b in bundles:
        b["descriptor"].release()
    for p in pools.values():
        p.shutdown()


if __name__ == "__main__":
    main()
