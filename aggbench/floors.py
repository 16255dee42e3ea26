"""The essential work of one exchange, from the configuration alone.

Every payload slab is read once and written once, self slabs included
(the reference counts them: ``AggregatorPattern.total_bytes``), whatever
implements the exchange: ``2 * nprocs * cb_nodes * data_size`` bytes. An
all-to-many and a many-to-all exchange move the same slabs. Index
tables, temporaries, barrier tokens and the zeroing of rows that receive
nothing are the program's own cost and are not counted.
"""

from __future__ import annotations

from aggbench.peaks import HBM_BYTES_PER_S


def payload_bytes(config: dict) -> int:
    return config["nprocs"] * config["cb_nodes"] * config["data_size"]


def essential_bytes(config: dict) -> int:
    return 2 * payload_bytes(config)


def floor_seconds(config: dict, device_kind: str) -> float | None:
    """The least time the card could take to move the essential bytes,
    or None for a card whose peak is not in the table."""
    peak = HBM_BYTES_PER_S.get(device_kind)
    if peak is None:
        return None
    return essential_bytes(config) / peak
