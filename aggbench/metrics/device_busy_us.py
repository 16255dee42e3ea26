"""Kernels: the union of the device operations' intervals in the
profiled slice over its exchanges, in microseconds."""


def read(record):
    prof = record.profile
    if not prof or prof["busy_s"] <= 0:
        return None
    return prof["busy_s"] / prof["exchanges"] * 1e6
