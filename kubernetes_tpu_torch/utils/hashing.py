"""Stable string hashing for device-side label/taint/name matching.

Strings become fixed-width integer hashes computed once on the host at
encode time; every device-side comparison is integer equality. FNV-1a
64-bit split into two uint32 lanes gives a 64-bit match space (both lanes
must collide at once). Hash value 0 is the "empty slot" sentinel: real
hashes that land on 0 are remapped to 1.

The pure-Python FNV-1a path only; it is bit-identical to the reference
package's hashes, which the parity tests rely on.
"""

from __future__ import annotations

_FNV64_OFFSET = 0xCBF29CE484222325
_FNV64_PRIME = 0x100000001B3
_MASK64 = 0xFFFFFFFFFFFFFFFF


def fnv1a64(data: str | bytes) -> int:
    """FNV-1a 64-bit hash of a string (utf-8) or bytes."""
    if isinstance(data, str):
        data = data.encode("utf-8")
    h = _FNV64_OFFSET
    for b in data:
        h = ((h ^ b) * _FNV64_PRIME) & _MASK64
    return h


def hash_lanes(data: str | bytes) -> tuple[int, int]:
    """Return (lo32, hi32) uint32 lanes of fnv1a64, each remapped 0 -> 1."""
    h = fnv1a64(data)
    lo = h & 0xFFFFFFFF
    hi = (h >> 32) & 0xFFFFFFFF
    return (lo or 1, hi or 1)


def hash32(data: str | bytes) -> int:
    """Single uint32 hash lane (the lo lane), 0 remapped to 1."""
    return hash_lanes(data)[0]
