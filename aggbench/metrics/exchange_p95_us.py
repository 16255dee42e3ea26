"""The 95th percentile, nearest rank, over every exchange of the window,
of the host wall from the rep call to the end of its synchronize, in
microseconds."""

import math


def read(record):
    walls = sorted(record.walls_s)
    if not walls:
        return None
    return walls[math.ceil(0.95 * len(walls)) - 1] * 1e6
