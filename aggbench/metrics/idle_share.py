"""Device: the share of an exchange's plain wall in which no device
operation ran, one minus the device's busy time an exchange (the union
of device intervals in the profiled slice, over its exchanges) over the
seconds an exchange of the same run's window took, which no profiler
slows. The profiler's host overhead would double a host-bound wall, so
the slice's own wall (``device.window_s``) is not the denominator. The
share is not clipped: on a device-bound cell the profiled kernels may
run a little longer than the window's, and it reads just below 0."""


def read(record):
    prof = record.profile
    if (not prof or prof["busy_s"] <= 0 or not record.exchanges
            or record.window_s <= 0):
        return None
    busy = prof["busy_s"] / prof["exchanges"]
    return 1.0 - busy / (record.window_s / record.exchanges)
