"""Schedule and tables: the host seconds of building the schedule
(``core/``) and the backend's first build of its rep, before any timed
exchange."""


def read(record):
    return record.split.get("tables_s")
