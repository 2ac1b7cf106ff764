"""Closed loop: one caller multiplies back to back, each multiply starting
when the last has returned and its C is on the device.

Traffic parameter: ``plan_cache`` (false: every multiply plans from
scratch; true: the set-up multiply fills the port's plan cache and every
multiply of the window replays it). Set-up is one multiply at the cell's
shapes. The multiplies rotate through the operands' value sets, so
consecutive multiplies share the pattern and differ in values. The window
ends with the multiply in flight when ``seconds`` have passed.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Tuple


@dataclasses.dataclass
class Record:
    t0: float
    t1: float
    value_set: int
    report: object


@dataclasses.dataclass
class Window:
    t_start: float
    t_end: float
    records: List[Record]
    held: Dict[int, Tuple[int, object]]   # multiply index -> (value set, C)


class ClosedLoop:
    def __init__(self, port, ops, params: dict, sync: Callable[[], None]):
        self.port = port
        self.plan_cache = bool(params["plan_cache"])
        self.sync = sync
        a, rhs = ops.a, ops.rhs
        a_ptr, a_idx = a.indptr.int(), a.indices.int()
        b_ptr, b_idx = ((a_ptr, a_idx) if rhs is a
                        else (rhs.indptr.int(), rhs.indices.int()))
        self.pairs = []
        for v in range(a.value_sets):
            ca = port.csr(a_ptr, a_idx, a.values[v], a.shape)
            cb = ca if rhs is a else port.csr(b_ptr, b_idx, rhs.values[v],
                                              rhs.shape)
            self.pairs.append((ca, cb))

    def _multiply(self, i: int):
        c, report = self.port.multiply(*self.pairs[i % len(self.pairs)],
                                       self.plan_cache)
        self.sync()
        return c, report

    def warm_up(self) -> float:
        """The set-up multiply; returns its wall."""
        t0 = time.perf_counter()
        self._multiply(0)
        return time.perf_counter() - t0

    def measure(self, seconds: float, keep: int) -> Window:
        """Multiply back to back for ``seconds``; hold the C of multiply
        ``keep`` and of the last one for the check."""
        records: List[Record] = []
        held: Dict[int, Tuple[int, object]] = {}
        last = None
        i = 0
        t_start = time.perf_counter()
        while True:
            v = (1 + i) % len(self.pairs)
            t0 = time.perf_counter()
            c, report = self._multiply(1 + i)
            t1 = time.perf_counter()
            records.append(Record(t0, t1, v, report))
            if i == keep:
                held[i] = (v, c)
            last = (i, v, c)
            i += 1
            if t1 - t_start >= seconds:
                break
        held[last[0]] = last[1:]
        return Window(t_start, records[-1].t1, records, held)


def make(port, ops, params: dict, sync: Callable[[], None]) -> ClosedLoop:
    return ClosedLoop(port, ops, params, sync)
