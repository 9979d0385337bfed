"""ONNX import preflight: can the port serve this model, and what's in it?

    python -m tpulab_torch.tools.onnx_summary model.onnx

Prints one JSON object: producer/opset, IO contract, op histogram, any
ops OUTSIDE the importer's registry (the would-be NotImplementedErrors,
surfaced before you build), weight bytes, and external-data sidecars.
Exits 0 for an importable model and 2 otherwise.  The reference's analog
is running build.py and reading the TRT parser's error log; this answers
the question without building anything, and touches no device: the
graph is parsed on the host, external sidecars are inventoried and
never read.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
from typing import List, Optional


def summarize(path: str) -> dict:
    from tpulab_torch.models.onnx_import import parse_onnx, supported_ops

    # preflight mode: external sidecars are inventoried, never read — a
    # >2 GB external-weights model summarizes without touching its bytes
    sidecars: list = []
    om = parse_onnx(path, collect_external=sidecars)
    g = om.graph
    ops = collections.Counter(n.op for n in g.nodes)
    supported = supported_ops()
    unsupported = sorted(op for op in ops if op not in supported)
    init_names = set(g.initializers)
    weight_bytes = int(sum(v.nbytes for v in g.initializers.values()))
    return {
        "file": os.path.abspath(path),
        "producer": om.producer,
        "opset": om.opset,
        "graph": g.name,
        "inputs": [{"name": n, "dtype": (str(dt) if dt else None),
                    "dims": d}
                   for n, dt, d in g.inputs if n not in init_names],
        "outputs": [{"name": n, "dims": d} for n, _dt, d in g.outputs],
        "nodes": sum(ops.values()),
        "op_histogram": dict(ops.most_common()),
        "unsupported_ops": unsupported,
        "importable": not unsupported,
        "initializers": len(g.initializers),
        "weight_bytes": weight_bytes,
        "external_sidecars": sorted({e["location"] for e in sidecars}),
    }


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("model", help="path to model.onnx")
    args = ap.parse_args(argv)
    out = summarize(args.model)
    print(json.dumps(out, indent=2))
    return 0 if out["importable"] else 2


if __name__ == "__main__":
    sys.exit(main())
