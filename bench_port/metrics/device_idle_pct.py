"""``device_idle_pct.*``: the share of the traced window that no device
activity (kernel, copy or memset, on any stream) covers."""


def read(record: dict, name: str):
    trace = record.get("trace")
    if not trace or not trace.get("device_events"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
