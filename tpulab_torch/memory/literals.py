"""Byte-size literals and parsing (reference literals.h, core utils.h:43)."""

from __future__ import annotations

import re

KiB = 1024
MiB = 1024 * KiB
GiB = 1024 * MiB

_UNITS = {
    "b": 1,
    "kb": 1000, "kib": KiB,
    "mb": 1000 ** 2, "mib": MiB,
    "gb": 1000 ** 3, "gib": GiB,
    "tb": 1000 ** 4, "tib": GiB * 1024,
}

_SIZE_RE = re.compile(r"^\s*([0-9]*\.?[0-9]+)\s*([a-zA-Z]*)\s*$")


def string_to_bytes(s: str | int) -> int:
    """Parse '10MiB'-style size strings (reference core utils.cc StringToBytes).

    Accepts bare integers, decimal values, and b/kb/kib/mb/mib/gb/gib/tb/tib
    suffixes (case-insensitive).
    """
    if isinstance(s, int):
        return s
    m = _SIZE_RE.match(s)
    if not m:
        raise ValueError(f"cannot parse byte size: {s!r}")
    value, unit = m.groups()
    unit = unit.lower() or "b"
    if unit not in _UNITS:
        raise ValueError(f"unknown byte-size unit {unit!r} in {s!r}")
    return int(float(value) * _UNITS[unit])


def bytes_to_string(n: int) -> str:
    """Human-readable byte size (reference core utils.cc BytesToString)."""
    x = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(x) < 1024.0 or unit == "TiB":
            if unit == "B":
                return f"{int(x)} B"
            return f"{x:.2f} {unit}"
        x /= 1024.0
    raise AssertionError


def align_up(value: int, alignment: int) -> int:
    """Round up to an alignment boundary (reference align.h)."""
    if alignment <= 0 or (alignment & (alignment - 1)):
        raise ValueError(f"alignment must be a positive power of two: {alignment}")
    return (value + alignment - 1) & ~(alignment - 1)


def align_down(value: int, alignment: int) -> int:
    if alignment <= 0 or (alignment & (alignment - 1)):
        raise ValueError(f"alignment must be a positive power of two: {alignment}")
    return value & ~(alignment - 1)


def is_aligned(value: int, alignment: int) -> bool:
    return (value % alignment) == 0


def ilog2(n: int) -> int:
    """Integer log2 (reference utils.h ilog2)."""
    if n <= 0:
        raise ValueError("ilog2 requires a positive value")
    return n.bit_length() - 1
