"""Counter-mode PRNG for device-resident sampling.

The coin for the token drawn after consuming stream position ``p`` is a
pure function of ``(request seed, p, draw channel)``: no generator state
exists, so a stream is identical however its decode is chunked, and a host
replay from fetched logits draws the same coins. The mixer is a 32-bit
xorshift-multiply avalanche (two shift-xor/multiply rounds).

Implemented twice with the same integer arithmetic: on Python ints (host)
and on torch tensors (device). torch has no full uint32 arithmetic, so the
device half computes on int64 and masks with ``& 0xFFFFFFFF`` after every
multiply; products of two 32-bit values stay below 2**64 only as unsigned,
so each multiply first splits one operand into 16-bit halves.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_GOLD = 0x9E3779B9  # 2**32 / phi
_MIX1 = 0x7FEB352D
_MIX2 = 0x846CA68B
_SALT = 0x85EBCA6B

# draw channels: independent uniforms one position can consume
DRAW_SAMPLE = 0
DRAW_SPEC_ACCEPT = 1
DRAW_SPEC_REDRAW = 2

_INV24 = 1.0 / 16777216.0  # coins are the top 24 mixed bits, exact in f32


# ----------------------------------------------------------------------
# Host side: plain Python ints
# ----------------------------------------------------------------------


def mix32(x: int) -> int:
    x &= _M32
    x ^= x >> 16
    x = (x * _MIX1) & _M32
    x ^= x >> 15
    x = (x * _MIX2) & _M32
    x ^= x >> 16
    return x


def fold_seed(seed: int) -> int:
    """Fold an arbitrary-width request seed into the uint32 counter key."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return mix32((s & _M32) ^ mix32(((s >> 32) & _M32) ^ _GOLD))


def coin_u32(seed32: int, pos: int, draw: int = DRAW_SAMPLE) -> int:
    return mix32(
        (seed32 & _M32)
        ^ mix32(((int(pos) * _GOLD) & _M32) ^ ((int(draw) * _SALT) & _M32))
    )


def coin_f32(seed32: int, pos: int, draw: int = DRAW_SAMPLE) -> np.float32:
    return np.float32((coin_u32(seed32, pos, draw) >> 8) * _INV24)


# ----------------------------------------------------------------------
# Device side: int64 tensors holding uint32 values
# ----------------------------------------------------------------------


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x in [0, 2**32) held in int64: split c so no
    partial product leaves the signed 64-bit range."""
    lo, hi = c & 0xFFFF, c >> 16
    return ((x * lo) + (((x * hi) & 0xFFFF) << 16)) & _M32


def device_mix32(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.int64) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, _MIX1)
    x = x ^ (x >> 15)
    x = _mul32(x, _MIX2)
    x = x ^ (x >> 16)
    return x


def device_coin_u32(seeds: torch.Tensor, pos: torch.Tensor, draw: int = DRAW_SAMPLE) -> torch.Tensor:
    """:func:`coin_u32` elementwise: ``seeds`` holds folded uint32 words and
    ``pos`` positions (broadcast together); returns int64 in [0, 2**32)."""
    p = _mul32(pos.to(torch.int64) & _M32, _GOLD)
    d = (draw * _SALT) & _M32
    return device_mix32((seeds.to(torch.int64) & _M32) ^ device_mix32(p ^ d))


def device_coin(seeds: torch.Tensor, pos: torch.Tensor, draw: int = DRAW_SAMPLE) -> torch.Tensor:
    """Uniform f32 coins in [0, 1), bit-identical to :func:`coin_f32`."""
    u = device_coin_u32(seeds, pos, draw) >> 8
    return u.to(torch.float32) * np.float32(_INV24)
