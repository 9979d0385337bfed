"""DLPack-based dtype descriptors (reference types.h:40-139, types.cc).

``DType`` wraps a DLPack {code, bits, lanes} triple with byte size and numpy
interop — the framework's common currency for binding specs and wire tensors.

numpy has no bfloat16 of its own (tpulab takes ml_dtypes', which the port
does not load), so ``bfloat16.to_numpy()`` raises ``TypeError``; every
other answer, ``is_compatible`` and ``dtype_from_numpy`` of an ml_dtypes
bfloat16 included, is tpulab's.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum

import numpy as np


class DLDataTypeCode(IntEnum):
    kDLInt = 0
    kDLUInt = 1
    kDLFloat = 2
    kDLBfloat = 4


_DL_TO_NUMPY = {
    (DLDataTypeCode.kDLFloat, 16): np.float16,
    (DLDataTypeCode.kDLFloat, 32): np.float32,
    (DLDataTypeCode.kDLFloat, 64): np.float64,
    (DLDataTypeCode.kDLInt, 8): np.int8,
    (DLDataTypeCode.kDLInt, 16): np.int16,
    (DLDataTypeCode.kDLInt, 32): np.int32,
    (DLDataTypeCode.kDLInt, 64): np.int64,
    (DLDataTypeCode.kDLUInt, 8): np.uint8,
    (DLDataTypeCode.kDLUInt, 16): np.uint16,
    (DLDataTypeCode.kDLUInt, 32): np.uint32,
    (DLDataTypeCode.kDLUInt, 64): np.uint64,
}


@dataclass(frozen=True)
class DType:
    """DLPack data type (reference dtype wrapping DLDataType)."""

    code: DLDataTypeCode
    bits: int
    lanes: int = 1

    @property
    def itemsize(self) -> int:
        return (self.bits * self.lanes + 7) // 8

    # -- numpy interop ------------------------------------------------------
    def to_numpy(self) -> np.dtype:
        key = (self.code, self.bits)
        if key not in _DL_TO_NUMPY:
            raise TypeError(f"no numpy equivalent for {self}")
        return np.dtype(_DL_TO_NUMPY[key])

    def is_compatible(self, np_dtype) -> bool:
        """Numpy-compat check (reference dtype::is_compatible)."""
        try:
            d = np.dtype(np_dtype)
            if (self.code, self.bits) == (DLDataTypeCode.kDLBfloat, 16):
                return d.name == "bfloat16"
            return d == self.to_numpy()
        except TypeError:
            return False

    def __str__(self) -> str:
        code = {0: "int", 1: "uint", 2: "float", 4: "bfloat"}[int(self.code)]
        suffix = f"x{self.lanes}" if self.lanes != 1 else ""
        return f"{code}{self.bits}{suffix}"


# canonical instances (reference ArrayType<T> table)
int8 = DType(DLDataTypeCode.kDLInt, 8)
int16 = DType(DLDataTypeCode.kDLInt, 16)
int32 = DType(DLDataTypeCode.kDLInt, 32)
int64 = DType(DLDataTypeCode.kDLInt, 64)
uint8 = DType(DLDataTypeCode.kDLUInt, 8)
uint16 = DType(DLDataTypeCode.kDLUInt, 16)
uint32 = DType(DLDataTypeCode.kDLUInt, 32)
uint64 = DType(DLDataTypeCode.kDLUInt, 64)
float16 = DType(DLDataTypeCode.kDLFloat, 16)
float32 = DType(DLDataTypeCode.kDLFloat, 32)
float64 = DType(DLDataTypeCode.kDLFloat, 64)
bfloat16 = DType(DLDataTypeCode.kDLBfloat, 16)


def dtype_from_numpy(np_dtype) -> DType:
    """Map a numpy (or ml_dtypes) dtype to a DType."""
    d = np.dtype(np_dtype)
    if d.name == "bfloat16":
        return bfloat16
    table = {
        "float16": float16, "float32": float32, "float64": float64,
        "int8": int8, "int16": int16, "int32": int32, "int64": int64,
        "uint8": uint8, "uint16": uint16, "uint32": uint32, "uint64": uint64,
    }
    if d.name not in table:
        raise TypeError(f"unsupported numpy dtype {d}")
    return table[d.name]
