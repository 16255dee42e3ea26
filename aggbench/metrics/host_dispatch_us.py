"""Rep dispatch: the mean host wall from the rep call to its return,
before the synchronize, over every exchange of a traced run's window,
in microseconds."""


def read(record):
    if not record.dispatch_s:
        return None
    return sum(record.dispatch_s) / len(record.dispatch_s) * 1e6
