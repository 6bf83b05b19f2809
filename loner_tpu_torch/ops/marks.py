"""Layer marks: a timestamp written on the device at a layer boundary.

On a CUDA tensor ``mark`` launches ``csrc/marks.cu::loner_mark_kernel<ID>``,
which writes the device's global timer (ns) into ``ring[slot + offset, ID]``
(``slot`` a device int64 scalar, read when the kernel runs, so a captured mark
writes the row of the replayed iteration). On a CPU tensor the plain version
writes ``time.perf_counter_ns()`` into the same place. Without ``slot`` the
mark writes ``ring.view(-1)[ID]`` (the anchor of ``runtime/profiling.py``).
"""
from __future__ import annotations

import ctypes
import functools
import time
from typing import Optional

import torch

MAX_MARKS = 16  # instances of loner_mark_kernel<ID> in csrc/marks.cu


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from loner_tpu_torch.ops.build import load_library

    lib = load_library("marks")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lt_mark.argtypes = [i, p, p, i, i, i, p]
    lib.lt_mark.restype = ctypes.c_int
    return lib


def mark(mark_id: int, ring: torch.Tensor, slot: Optional[torch.Tensor] = None,
         offset: int = 0) -> None:
    """Write the time into ``ring`` (int64, (rows, n_marks)) at row ``slot +
    offset`` (row 0 without ``slot``), column ``mark_id``; a row outside the
    ring is not written."""
    rows, n_marks = ring.shape
    if not 0 <= mark_id < min(n_marks, MAX_MARKS):
        raise ValueError(f"mark {mark_id} of a ring of {n_marks} marks (at most {MAX_MARKS})")
    if ring.dtype != torch.int64 or not ring.is_contiguous():
        raise ValueError("the ring must be a contiguous int64 tensor")
    if ring.device.type != "cuda":
        row = 0 if slot is None else int(slot) + offset
        if 0 <= row < rows:
            ring[row, mark_id] = time.perf_counter_ns()
        return
    with torch.cuda.device(ring.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().lt_mark(mark_id, ctypes.c_void_p(ring.data_ptr()),
                            ctypes.c_void_p(0 if slot is None else slot.data_ptr()),
                            rows, n_marks, offset, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"lt_mark failed with CUDA error {rc}")
