"""Geometry of the precision-scalable INT MAC array (§II-D, Fig. 5).

Port of the geometry half of ``repro.core.mac_array`` (:41-125): the
macro is a 64×96 SRAM-based array of 2-bit MAC columns; a W-bit weight
takes W/2 adjacent columns, and inputs stream bit-serially.  The energy
model (:mod:`repro_torch.core.energy`) reads these shapes.  The
slice/fuse datapath itself (``slice_weights``, ``fuse_columns``,
``column_mac``, ``mac_array_matmul``) comes with the circuit models
(ROADMAP A15).
"""
from __future__ import annotations

import dataclasses

__all__ = [
    "ArrayGeometry",
    "GEOMETRY",
    "effective_output_columns",
    "macro_cycles",
]


@dataclasses.dataclass(frozen=True)
class ArrayGeometry:
    rows: int = 64  # group size G: elements per MAC column
    cols: int = 96  # physical 2b columns
    ops_per_mac: int = 2  # multiply + accumulate


GEOMETRY = ArrayGeometry()


def effective_output_columns(width: int, geo: ArrayGeometry = GEOMETRY) -> int:
    """Physical columns each hold one 2b slice -> outputs per array pass."""
    return geo.cols // (width // 2)


def macro_cycles(m: int, k: int, n: int, i_bits: int, w_bits: int,
                 geo: ArrayGeometry = GEOMETRY) -> int:
    """Cycles for an (m,k,n) GEMM on the macro.

    Inputs stream bit-serially (i_bits cycles per activation vector); each
    pass covers 64 reduction rows × (96/(W/2)) outputs.
    """
    passes_k = -(-k // geo.rows)
    passes_n = -(-n // effective_output_columns(w_bits, geo))
    return m * passes_k * passes_n * i_bits
