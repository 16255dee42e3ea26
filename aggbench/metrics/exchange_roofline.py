"""Kernels: the exchange's share of its roofline, in percent: the least
time the card could move the essential bytes in
(:func:`aggbench.floors.floor_seconds`, from the configuration alone)
over the device busy time of one exchange in the profiled slice."""

from aggbench.floors import floor_seconds


def read(record):
    prof = record.profile
    if not prof or prof["busy_s"] <= 0:
        return None
    floor = floor_seconds(record.config, record.device_kind)
    if floor is None:
        return None
    return floor / (prof["busy_s"] / prof["exchanges"]) * 100.0
