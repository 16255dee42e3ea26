"""Wall time per exchange: the window's seconds over the exchanges that
finished in it, in microseconds (host clock)."""


def read(record):
    if not record.exchanges:
        return None
    return record.window_s * 1e6 / record.exchanges
