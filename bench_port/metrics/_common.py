"""Arithmetic shared by the readers."""


def per_unit(record: dict, key: str, scale: float = 1.0):
    """A trace quantity over the units of work of the traced window, or
    None where the trace holds no device activity."""
    trace = record.get("trace")
    if not trace or not trace.get("device_events") or not record["units"]:
        return None
    return trace[key] * scale / record["units"]
