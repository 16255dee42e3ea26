"""Kernels: the TAM relay's share of its roofline, in percent. The relay
moves every payload slab three times (P2 into the proxies' staging, P3
between proxies, P4/P5 into the receivers' slots), each hop reading and
writing it once, whatever implements it: :func:`relay_bytes`. Its
floor, those bytes at the card's HBM peak, over the device busy time of
one exchange in the profiled slice."""

from aggbench.floors import essential_bytes
from aggbench.peaks import HBM_BYTES_PER_S

HOPS = 3


def relay_bytes(config: dict) -> int:
    return HOPS * essential_bytes(config)


def read(record):
    prof = record.profile
    peak = HBM_BYTES_PER_S.get(record.device_kind)
    if not prof or prof["busy_s"] <= 0 or peak is None:
        return None
    floor = relay_bytes(record.config) / peak
    return floor / (prof["busy_s"] / prof["exchanges"]) * 100.0
