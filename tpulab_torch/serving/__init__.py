"""Serving frontend: admission control & QoS (the port of
``tpulab/serving``).

The explicit layer between the RPC services and the engines: decide at
the RPC boundary whether a request runs, waits in a per-tenant fair
queue, or fails fast with ``RESOURCE_EXHAUSTED`` + ``retry_after_ms`` —
before it consumes a lane, KV pages, or a session lease.
"""

from tpulab_torch.serving.admission import (DEFAULT_TENANT,  # noqa: F401
                                            REQUEST_CLASS_BATCH,
                                            REQUEST_CLASS_ONLINE,
                                            REQUEST_CLASSES,
                                            TENANT_METADATA_KEY,
                                            AdmissionConfig,
                                            AdmissionController,
                                            AdmissionRejected,
                                            AdmissionTicket, TokenBucket,
                                            tenant_of_request)
from tpulab_torch.serving.fair_queue import \
    DeficitRoundRobinQueue  # noqa: F401
