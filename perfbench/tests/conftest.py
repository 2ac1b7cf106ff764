"""Fixtures shared by the benchmark's tests.

``test_perfbench_run`` runs every cell on the CPU at a small size, the
configuration's keys overridden from its module's ``SMALL`` (by
configuration name). Configurations added after that file give their
small sizes here, and every test module with a ``SMALL`` sees them."""
import pytest

SMALL = {"fem-q1-gamg-rap": {"ne": 5}}


@pytest.fixture(autouse=True)
def small_sizes_of_later_configs(request, monkeypatch):
    small = getattr(request.module, "SMALL", None)
    if isinstance(small, dict):
        for name, override in SMALL.items():
            monkeypatch.setitem(small, name, override)
