"""Kubernetes resource.Quantity parsing.

The reference represents resource amounts as `resource.Quantity` strings
("100m", "1Gi", "0.5", "1e3") and converts them to milli-units or bytes for
scheduling math (vendor/k8s.io/apimachinery/pkg/api/resource/quantity.go;
consumed at plugin/pkg/scheduler/schedulercache/node_info.go via
`Resource{MilliCPU, Memory, ...}`). We implement the same grammar with exact
decimal arithmetic so host-side encoding never loses precision before it
quantizes to device dtypes.
"""

from __future__ import annotations

from decimal import Decimal
from fractions import Fraction
from functools import lru_cache

_BINARY_SUFFIXES = {
    "Ki": 1024,
    "Mi": 1024**2,
    "Gi": 1024**3,
    "Ti": 1024**4,
    "Pi": 1024**5,
    "Ei": 1024**6,
}

_DECIMAL_SUFFIXES = {
    "n": Fraction(1, 10**9),
    "u": Fraction(1, 10**6),
    "m": Fraction(1, 10**3),
    "": Fraction(1),
    "k": Fraction(10**3),
    "M": Fraction(10**6),
    "G": Fraction(10**9),
    "T": Fraction(10**12),
    "P": Fraction(10**15),
    "E": Fraction(10**18),
}


def parse_quantity(value: str | int | float) -> Fraction:
    """Parse a Kubernetes quantity into an exact Fraction of base units.

    Accepts ints/floats for convenience (treated as base units). String
    parses are memoized — clusters reuse a handful of distinct quantity
    strings, and Fraction/Decimal construction dominates the host-side
    accounting path otherwise.
    """
    if isinstance(value, Fraction):
        return value
    if isinstance(value, (int, float)):
        return Fraction(Decimal(str(value)))
    return _parse_str(value)


@lru_cache(maxsize=65536)
def _parse_str(value: str) -> Fraction:
    s = value.strip()
    if not s:
        raise ValueError("empty quantity")

    for suffix, mult in _BINARY_SUFFIXES.items():
        if s.endswith(suffix):
            return Fraction(Decimal(s[: -len(suffix)])) * mult

    # decimal-exponent form: 123e4 / 1.5E2 (no suffix letters besides e/E)
    num = s
    suffix = ""
    if s[-1] in _DECIMAL_SUFFIXES and s[-1] not in "eE":
        num, suffix = s[:-1], s[-1]
    try:
        return Fraction(Decimal(num)) * _DECIMAL_SUFFIXES[suffix]
    except Exception as e:  # noqa: BLE001
        raise ValueError(f"unparseable quantity {value!r}") from e

