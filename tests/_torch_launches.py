"""The port's launch counts for its tests: the ``launches`` fixture
installs a fresh metrics registry, into which the kernel wrappers count
(``kernel.launches{kernel}``), and restores the previous one after.

A test module takes it with ``from _torch_launches import launches``.
"""
import pytest

from repro_torch.obs import metrics


@pytest.fixture
def launches():
    """Yields the reader of the fresh registry's ``{kernel: launches}``."""
    reg = metrics.MetricsRegistry()
    prev = metrics.install_registry(reg)
    try:
        yield lambda: metrics.launch_counts(reg)
    finally:
        metrics.install_registry(prev)
