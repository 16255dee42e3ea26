"""Set-up: from the start of the process to the first timed exchange,
in seconds (host clock): imports, CUDA init, the kernel library, the
schedule and tables, the send fill and the warm-up."""


def read(record):
    return record.setup_s
