"""Rep lowering: device operations (kernels, copies, sets) in the
profiled slice over its exchanges."""


def read(record):
    prof = record.profile
    if not prof or not prof["device_events"]:
        return None
    return prof["device_events"] / prof["exchanges"]
