"""FIFO-based Input Alignment Unit (FIAU): behavioural model (§II-C, Fig. 4).

Port of ``repro.core.fiau``.  The FIAU replaces a parallel barrel shifter
with pointer control over a FIFO of 1-bit registers:

  * the 2's-complement mantissa is written serially MSB→LSB (``w_ptr``);
  * on read (``r_en``), ``r_ptr`` stays at the MSB for ``exp_offset+1``
    cycles (emitting the sign bit repeatedly, i.e. sign extension) before
    advancing, which realizes an arithmetic right shift by ``exp_offset``;
  * after ``save_len`` cycles ``r_ptr`` jumps to ``w_ptr`` for the next
    mantissa, truncating the output to ``save_len`` bits.

So the FIAU computes  out = floor( v / 2**(exp_offset + w_in - save_len) ),
emitted as a ``save_len``-bit 2's-complement integer: a barrel shifter
plus truncation, at a fraction of the area and power (the 28 nm
constants are in :mod:`repro_torch.core.energy`).

Two implementations:
  * :func:`fiau_serial`: the literal cycle-by-cycle pointer machine (pure
    Python, the circuit's ground truth and its cycle count);
  * :func:`barrel_align`: the vectorized barrel-shifter reference the FIAU
    must match bit for bit, on int64 tensors of any device.
"""
from __future__ import annotations

import torch

__all__ = ["fiau_serial", "barrel_align", "fiau_cycles", "barrel_cycles"]


def _to_bits_2c(v: int, width: int) -> list[int]:
    """2's-complement bit list, MSB first."""
    u = v & ((1 << width) - 1)
    return [(u >> (width - 1 - i)) & 1 for i in range(width)]


def _from_bits_2c(bits: list[int]) -> int:
    w = len(bits)
    u = 0
    for b in bits:
        u = (u << 1) | b
    if bits[0]:
        u -= 1 << w
    return u


def fiau_serial(v: int, w_in: int, exp_offset: int, save_len: int) -> tuple[int, int]:
    """Cycle-accurate FIAU read of one mantissa.

    Args:
      v: signed mantissa, must fit ``w_in``-bit 2's complement.
      w_in: FIFO entry width (mantissa bits + implicit bit + sign).
      exp_offset: the group shift (E_max - E_i).
      save_len: output precision in bits (aligned width B_g + sign).

    Returns:
      (aligned signed integer, cycles consumed).
    """
    assert -(1 << (w_in - 1)) <= v < (1 << (w_in - 1)), "mantissa overflows FIFO"
    fifo = _to_bits_2c(v, w_in)
    out: list[int] = []
    r_ptr = 0
    for cycle in range(save_len):
        bit = fifo[r_ptr] if r_ptr < w_in else 0  # past the LSB: empty slots read 0
        out.append(bit)
        if cycle >= exp_offset:  # r_ptr holds at the MSB for exp_offset+1 cycles
            r_ptr += 1
    # after save_len cycles r_ptr jumps to w_ptr (the next mantissa):
    # cycles = save_len reads
    return _from_bits_2c(out), save_len


def _int64(a, device=None) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.int64, device=device)


def barrel_align(v, exp_offset, w_in: int, save_len) -> torch.Tensor:
    """Vectorized barrel-shifter + truncate reference (int64 tensors).

    out = floor(v / 2**(exp_offset + w_in - save_len)) in save_len-bit 2c.
    Reads past the LSB (save_len > w_in + exp_offset) append zeros, like the
    FIAU's empty FIFO slots, i.e. a *left* shift of the remaining bits.
    Every operand lands on ``v``'s device (a tensor's, else the CPU).
    """
    v = _int64(v)
    exp_offset, save_len = _int64(exp_offset, v.device), _int64(save_len, v.device)
    sh = exp_offset + w_in - save_len
    # torch's shift by a negative amount is undefined: both amounts >= 0
    out = torch.where(sh >= 0, v >> sh.clamp(min=0), v << (-sh).clamp(min=0))
    lim = torch.ones_like(save_len) << (save_len - 1)
    return torch.minimum(torch.maximum(out, -lim), lim - 1)


def fiau_cycles(exp_offset, save_len) -> torch.Tensor:
    """Cycles per element: the serial read is save_len cycles (the sign-hold
    overlaps the read); alignment is overlapped with MPU compute (§II-B)."""
    del exp_offset
    return _int64(save_len).clone()


def barrel_cycles(exp_offset, save_len) -> torch.Tensor:
    """A parallel barrel shifter aligns in a single cycle per element."""
    del exp_offset
    return torch.ones_like(_int64(save_len))
