"""Fixed-point gradient sums: exact, and the same bits in any order.

The hash table's and the occupancy grid's gradients are scatter-adds: many
points add ``w_k g`` to one entry. Float additions in the order the card's
atomics reach them round differently from run to run, and a sum split over
mesh ranks rounds differently from the sum on one card. Here every contribution
is scaled by an exact power of two, ``2^bits``, rounded half to even to int64
(``torch.round`` here, ``__float2ll_rn`` in ``csrc/hash_grid.cu``) and summed in
int64, which is associative; one pass converts each sum to f32 (round to
nearest even) and scales it by ``2^-bits``. The sums then have the same bits on
every run, under any permutation of the points, when the points are split into
parts whose int64 sums are added (a mesh's all-reduce), and in the kernel and
its plain version.

``HASH_BITS`` and ``OGM_BITS`` were chosen from readings of the reference
configuration on an H100 (``chip_smoke.py`` prints them: the largest
|contribution|, the largest |entry sum| and ``magnitude``, the sum of every
|contribution|; PERF.md section 6). A contribution below ``2^-(bits + 1)``
rounds to 0; one of at least ``2^(23 - bits)`` is an integer already and is
added exactly.

The guard: a sum's ``magnitude`` (the sum of |contribution| over everything
added into it, accumulated in f32 alongside) must stay below ``2^(LIMIT_BITS -
bits)``. Every partial sum of every order and split is then below 2^58 in
fixed-point units, with room for the f32 rounding of the magnitude itself, and
the int64 sum of up to MAX_PARTS such sums (the ranks of a mesh) stays below
2^63: nothing wraps. A sum that passes the limit (or is not finite) sets a
sticky flag: on the CPU ``to_float`` raises at once; on a CUDA device the flag
is a device scalar that ``check`` reads and raises on (a phase program at the
end of each phase, unless its caller reads ``flag`` itself: the ``Optimizer``
copies it to the host with a keyframe's results). Nothing saturates or clamps.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Tuple

import torch

HASH_BITS = 40  # the hash tables' scale: contributions in units of 2^-40
OGM_BITS = 28  # the occupancy grid's scale
LIMIT_BITS = 58  # magnitude x 2^bits must stay below 2^LIMIT_BITS
MAX_PARTS = 16  # int64 sums of at most this many parts (mesh ranks) cannot wrap

_flags: Dict[Tuple[str, int], torch.Tensor] = {}
_flags_lock = threading.Lock()
# While ``recording``: (bits, device) -> (3,) f32 device maxima over every sum
# converted, of its magnitude, its largest |contribution| and its largest |entry
# sum|. Read at a capture, like any other op of the iteration.
_readings: Optional[Dict[Tuple[int, str], torch.Tensor]] = None


def flag(device: torch.device) -> torch.Tensor:
    """The sticky overflow flag of ``device``: an int32 device scalar, nonzero
    once a sum passed its limit. Made at the first use on a device (before any
    capture: a phase program's warm-up iterations run first)."""
    device = torch.device(device)
    key = (device.type, device.index if device.index is not None else
           (torch.cuda.current_device() if device.type == "cuda" else 0))
    with _flags_lock:
        if key not in _flags:
            _flags[key] = torch.zeros((), dtype=torch.int32,
                                      device=torch.device(key[0], key[1]) if key[0] == "cuda"
                                      else device)
        return _flags[key]


OVERFLOW = ("a fixed-point gradient sum passed its limit: the contributions' magnitude "
            "outgrew the scale (ops/fixed_point.py); the gradients are not exact")


def check(device: torch.device) -> None:
    """Raise OverflowError if a fixed-point sum on ``device`` passed its limit
    since the flag was last cleared (a host synchronisation on a CUDA device)."""
    f = flag(device)
    if int(f.item()):
        f.zero_()
        raise OverflowError(OVERFLOW)


def to_fixed(values: torch.Tensor, bits: int) -> torch.Tensor:
    """f32 contributions as int64 in units of 2^-bits, rounded half to even."""
    return torch.round(values * 2.0 ** bits).to(torch.int64)


def from_fixed(acc: torch.Tensor, bits: int) -> torch.Tensor:
    """int64 sums as f32: one pass, the conversion rounds to nearest even and the
    scale by 2^-bits is exact."""
    return acc * 2.0 ** -bits


def limit(bits: int) -> float:
    """The largest magnitude (sum of |contribution|) a sum at ``bits`` takes."""
    return 2.0 ** (LIMIT_BITS - bits)


class FixedPointSum:
    """An int64 sum of f32 contributions at scale 2^bits, with its guard.

    ``acc``: the int64 sums (``shape``); ``mag``: (2,) f32, the sum of every
    |contribution| added and the largest one. ``acc`` may be a view into a
    larger int64 buffer (``out``), which a mesh all-reduces whole."""

    def __init__(self, shape, bits: int, device: torch.device, out: torch.Tensor = None):
        self.bits = bits
        self.acc = out.view(shape) if out is not None else torch.zeros(
            shape, dtype=torch.int64, device=device)
        self.mag = torch.zeros((2,), dtype=torch.float32, device=self.acc.device)

    def add_(self, index: torch.Tensor, values: torch.Tensor) -> None:
        """``acc.view(-1, F)[index[i]] += values[i]`` for (M, F) f32 ``values``, in
        fixed point (``index_add_`` on int64)."""
        self.mag[0] += torch.linalg.vector_norm(values, 1)
        if values.numel():
            lo, hi = torch.aminmax(values)
            self.mag[1:].copy_(torch.maximum(self.mag[1:], torch.maximum(hi, -lo)))
        self.acc.view(-1, values.shape[-1]).index_add_(0, index, to_fixed(values, self.bits))

    def guard(self) -> None:
        """Flag (CPU: raise) a magnitude past the limit or not finite."""
        over = ~(self.mag[0] < limit(self.bits))
        if self.acc.device.type != "cpu":
            flag(self.acc.device).bitwise_or_(over.to(torch.int32))
        elif bool(over):
            raise OverflowError(OVERFLOW)

    def to_float(self) -> torch.Tensor:
        """The sums as f32, after the guard."""
        self.guard()
        out = from_fixed(self.acc, self.bits)
        if _readings is not None:
            key = (self.bits, str(self.acc.device))
            if key not in _readings:
                _readings[key] = torch.zeros((3,), dtype=torch.float32, device=self.acc.device)
            r = _readings[key]
            r.copy_(torch.maximum(r, torch.cat([self.mag, out.abs().max().view(1)])))
        return out


@contextlib.contextmanager
def recording():
    """Within the block, every conversion (and every phase program captured in it)
    keeps the running maxima of its sum's magnitude, largest |contribution| and
    largest |entry sum|; the yielded dict maps ``bits`` to those three numbers,
    filled at the block's end (a host synchronisation)."""
    global _readings
    before, _readings = _readings, {}
    out: Dict[int, list] = {}
    try:
        yield out
    finally:
        taken, _readings = _readings, before
        for (bits, _), r in taken.items():
            prev = out.get(bits, [0.0, 0.0, 0.0])
            out[bits] = [max(a, float(b)) for a, b in zip(prev, r.tolist())]
