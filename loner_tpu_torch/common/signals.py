"""Signal/Slot message bus between the tracker and mapper threads.

Counterpart of ``loner_tpu/common/signals.py``: one process, host threads,
plain ``queue.Queue`` fan-out.

  * one Signal, many Slots; every emit is delivered to every registered slot
  * ``synchronous=True`` emits rendezvous: they block until all slots drained
  * ``StopSignal`` flows through the bus for the 2-phase shutdown
  * ``single_process`` mode deep-copies payloads, so a consumer cannot
    mutate what another one reads (the single-threaded deterministic mode)
"""
from __future__ import annotations

import copy
import queue
import threading
from typing import Any, Callable, List, Optional


class StopSignal:
    """Sentinel flushed through the bus at shutdown."""


class Slot:
    def __init__(self, deep_copy: bool) -> None:
        self._queue: "queue.Queue[Any]" = queue.Queue()
        self._deep_copy = deep_copy

    def _put(self, value: Any) -> None:
        if self._deep_copy and not isinstance(value, StopSignal):
            value = copy.deepcopy(value)
        self._queue.put(value)

    def has_value(self) -> bool:
        return not self._queue.empty()

    def get_value(self, block: bool = True, timeout: float = None) -> Any:
        value = self._queue.get(block=block, timeout=timeout)
        self._queue.task_done()
        return value

    def wait_drained(self, abort: Optional[Callable[[], bool]] = None) -> None:
        """Block until the consumer has taken every item put so far, asleep on
        the queue's condition: a polling loop would take the GIL from the
        launch-bound worker threads a thousand times a second. ``abort()`` is
        checked every 0.1 s."""
        q = self._queue
        with q.all_tasks_done:
            while q.unfinished_tasks:
                if abort is not None and abort():
                    raise RuntimeError("a consumer of this signal stopped")
                q.all_tasks_done.wait(0.1)


class Signal:
    def __init__(self, synchronous: bool = False, single_process: bool = False,
                 abort: Optional[Callable[[], bool]] = None) -> None:
        self._slots: List[Slot] = []
        self._synchronous = synchronous
        self._single_process = single_process
        # A synchronous emit stops waiting, and raises, once ``abort()`` is
        # true (a consumer thread has died and will never drain its slot).
        self._abort = abort
        self._lock = threading.Lock()

    def register(self) -> Slot:
        with self._lock:
            slot = Slot(deep_copy=self._single_process)
            self._slots.append(slot)
            return slot

    def emit(self, value: Any) -> None:
        with self._lock:
            slots = list(self._slots)
        for slot in slots:
            slot._put(value)
        # Rendezvous: wait until every consumer has drained the item
        # (reference signals.py:117-121, which busy-waits).
        # StopSignal is exempt: a consumer that already processed a stop
        # from another signal has exited its loop and will never drain
        # this one — rendezvous would deadlock the shutdown handshake.
        if (
            self._synchronous
            and not self._single_process
            and not isinstance(value, StopSignal)
        ):
            for slot in slots:
                slot.wait_drained(self._abort)


class SharedState:
    """Thread-shared scalars for tracker<->mapper throttling.

    Replaces the reference's ``mp.Value('d')`` (shared_state.py:15-17).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._last_mapped_frame_time: float = None

    @property
    def last_mapped_frame_time(self):
        with self._lock:
            return self._last_mapped_frame_time

    @last_mapped_frame_time.setter
    def last_mapped_frame_time(self, value: float) -> None:
        with self._lock:
            self._last_mapped_frame_time = value
