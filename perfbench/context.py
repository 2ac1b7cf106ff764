"""What a traced run hands to the per-layer metric readers."""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass
class TraceContext:
    """reports: the port's ``OceanReport`` of each multiply in the window.
    device_events: (start, end, name) of every device activity in the
    window, on the host's clock. window: (start, end) of the window.
    work: the counted work of one multiply (``rows``, ``cols``, ``nnz_a``,
    ``nnz_b``, ``nnz_c``, ``products``, ``same_operand``). widths: bytes of
    a row offset, a column index and a value, from the configuration.
    peaks: the card's published peaks, or None for a card not listed."""
    reports: List[object]
    device_events: List[Tuple[float, float, str]]
    window: Tuple[float, float]
    work: dict
    widths: dict
    peaks: Optional[dict]

    @property
    def multiplies(self) -> int:
        return len(self.reports)


def mean(values) -> Optional[float]:
    values = list(values)
    return sum(values) / len(values) if values else None
