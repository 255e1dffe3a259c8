"""Sizes at which the harness tests run each configuration on the CPU.

``test_portbench_correct.py`` runs every cell of ``BENCHMARK.json`` at the
size its table ``SMALL`` gives the cell's configuration; the configurations
added after that table take theirs from ``SMALL`` here, joined to it as the
tests are collected.

``hash1m-sphere`` at 2048 rows: its sphere of radius 10 then holds ~0.5
rows a cell, where ``hash_engine="auto"`` would take the tiles engine, so
the window engine (the cell's own, kernel K7's plain twin here) is named.
"""

import pytest

SMALL = {"hash1m-sphere": {"particle_count": 2048, "hash_engine": "window"}}


def pytest_collection_modifyitems(items):
    for item in items:
        table = getattr(getattr(item, "module", None), "SMALL", None)
        if isinstance(table, dict):
            for config, size in SMALL.items():
                table.setdefault(config, size)


@pytest.fixture
def hash_small():
    return dict(SMALL["hash1m-sphere"])
