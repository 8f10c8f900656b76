"""Precision-scalable INT MAC array: behavioural model (§II-D, Fig. 5).

Port of ``repro.core.mac_array``.  The macro is a 64×96 SRAM-based array
of 64×2b MAC columns.  A W-bit weight (W ∈ {2,4,6,8}, 2's complement) is
decomposed into W/2 two-bit slices stored in adjacent columns; per-column
dot products with the (bit-serial) input are fused by shift-and-add:

    w = Σ_j slice_j · 4**j,   slice_{top} signed (SNF=1), others unsigned,
    acc(x·w) = Σ_j (x · slice_j) · 4**j.

The 2/4/8b modes use the regular power-of-4 fusion path; the 6b mode fuses
*three* columns (the paper's dedicated low-overhead path).  A 4-2
compressor + full-adder tree per column performs the 64-row reduction;
here the tree is an exact integer sum (its structure only affects area
and power, tracked in :mod:`repro_torch.core.energy`, which also reads
the geometry below).

torch has no integer matmul on the card, so the column dots run in
:func:`repro_torch.core.dsbp.exact_dot_dtype` (float64 on the card,
never TF32): every product and partial sum of a 64-row column is an
integer below 2**24, so they are exact, and the results equal a plain
integer matmul for every width and input precision of 2-12 bits.
"""
from __future__ import annotations

import dataclasses

import torch

from .dsbp import exact_dot_dtype

__all__ = [
    "ArrayGeometry",
    "GEOMETRY",
    "slice_weights",
    "fuse_columns",
    "column_mac",
    "mac_array_matmul",
    "effective_output_columns",
    "macro_cycles",
]


@dataclasses.dataclass(frozen=True)
class ArrayGeometry:
    rows: int = 64  # group size G: elements per MAC column
    cols: int = 96  # physical 2b columns
    ops_per_mac: int = 2  # multiply + accumulate


GEOMETRY = ArrayGeometry()


def slice_weights(w_int: torch.Tensor, width: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Decompose W-bit 2's-complement weights into 2b column slices.

    Returns (slices, snf): ``slices[..., j]`` holds slice j (LSB-first),
    values in [0,3] for unsigned slices and [-2,1] for the top (signed)
    slice; ``snf[j]`` is the signed-number flag per slice position.
    """
    if width not in (2, 4, 6, 8):
        raise ValueError(f"weight width must be 2/4/6/8, got {width}")
    n = width // 2
    w = torch.as_tensor(w_int).to(torch.int32)
    u = torch.where(w < 0, w + (1 << width), w)  # 2's-complement bits
    slices = []
    for j in range(n):
        s = (u >> (2 * j)) & 3
        if j == n - 1:  # top slice: signed 2-bit (SNF=1)
            s = torch.where(s >= 2, s - 4, s)
        slices.append(s)
    snf = torch.tensor([j == n - 1 for j in range(n)], device=w.device)
    return torch.stack(slices, dim=-1), snf


def fuse_columns(col_results: torch.Tensor, width: int) -> torch.Tensor:
    """Shift-and-add fusion of per-slice column MACs (incl. the 6b path).

    ``col_results[..., j]`` = dot(x, slice_j) over the 64 rows.  The fusion
    weight of slice j is 4**j; for width=6 this fuses three columns
    (1, 4, 16), the paper's dedicated path, which is numerically the same
    power-of-4 ladder, just an odd column count for the reuse mux.
    """
    n = width // 2
    w4 = torch.tensor([4**j for j in range(n)], dtype=torch.int32,
                      device=col_results.device)
    return (col_results.to(torch.int32) * w4).sum(dim=-1, dtype=torch.int32)


def _int_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., G) @ (G, C) of integer tensors, exact, as int32."""
    dt = exact_dot_dtype(x.device)
    return torch.matmul(x.to(dt), w.to(dt)).to(torch.int32)


def column_mac(x_int: torch.Tensor, w_slices: torch.Tensor) -> torch.Tensor:
    """Per-column 64-row dot products: (..., G) x (G, n_slices) -> (..., n_slices).

    Inputs are bit-serial in hardware (I cycles/bit); numerically that is an
    exact integer dot, computed here in one shot.
    """
    return _int_dot(torch.as_tensor(x_int), torch.as_tensor(w_slices))


def mac_array_matmul(x_int: torch.Tensor, w_int: torch.Tensor, width: int) -> torch.Tensor:
    """Full-array GEMM through the slice/fuse datapath.

    x_int: (..., G) aligned input mantissas (any 2-12b signed range)
    w_int: (G, N) aligned weight mantissas in W-bit 2's complement
    Returns (..., N) int32, equal to ``x_int @ w_int``.
    """
    x_int = torch.as_tensor(x_int)
    slices, _ = slice_weights(torch.as_tensor(w_int, device=x_int.device), width)
    g, n, s = slices.shape
    cols = _int_dot(x_int, slices.reshape(g, n * s))
    return fuse_columns(cols.reshape(*cols.shape[:-1], n, s), width)


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
