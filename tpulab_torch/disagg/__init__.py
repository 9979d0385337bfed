"""tpulab_torch.disagg — disaggregated prefill/decode: KV shipping over
the host tier (the port of ``tpulab/disagg``).

A prefill replica runs the prompt forward only and exports the finished
KV from its host tier in **wire form**; a decode replica admits the
request by **restoring the shipped KV** through
``KVOffloadManager.restore`` — zero prefill dispatches on the decode
side, the same tokens.

- :mod:`~tpulab_torch.disagg.wire` — versioned, CRC-checked snapshot
  encoding, byte for byte tpulab's (:func:`serialize_snapshot` /
  :func:`deserialize_snapshot`, :class:`WireFormatError`,
  :func:`prompt_digest`).  Mismatched replicas reject instead of
  corrupt.
- :class:`~tpulab_torch.disagg.shipper.KVShipper` — export on the prefill
  replica (write-behind fence included), import + geometry validation on
  the decode replica.  ``disagg.ship`` chaos point on both sides; every
  failure degrades to local prefill on the decode replica.

Batcher wire-up: ``submit(prompt, 1, export_digest=...)`` on the prefill
replica (the export handle lands on the future as
``_tpulab_kv_export``), ``submit_shipped(...)`` on the decode replica.
tpulab's ``benchmark_disagg`` waits for the port's bench (ROADMAP queue
1, item 4); replica roles and routing wait for the serving layer.
"""

from tpulab_torch.disagg.shipper import KVShipper, ShippedKV  # noqa: F401
from tpulab_torch.disagg.wire import (WireFormatError,  # noqa: F401
                                      deserialize_snapshot, prompt_digest,
                                      serialize_snapshot)

__all__ = ["KVShipper", "ShippedKV", "WireFormatError",
           "serialize_snapshot", "deserialize_snapshot", "prompt_digest"]
