"""Fleet-wide KV fabric: any replica adopts any replica's prefix KV (the
port of ``tpulab/kvfabric``).

See :mod:`tpulab_torch.kvfabric.fabric` for the design; docs/SERVING.md
"Fleet KV fabric" for the operator view.
"""

from tpulab_torch.kvfabric.fabric import KVFabric, PulledKV, fabric_export


def benchmark_kv_fabric(**kw):
    from tpulab_torch.kvfabric.bench import benchmark_kv_fabric as _b
    return _b(**kw)


__all__ = ["KVFabric", "PulledKV", "fabric_export", "benchmark_kv_fabric"]
