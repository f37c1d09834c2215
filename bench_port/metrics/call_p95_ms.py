"""``call_p95_ms``: the 95th percentile of the wall time of every call in
the window, each from its start to the synchronise after it."""

import statistics


def read(record: dict, name: str):
    lat = record["latencies"]
    if len(lat) < 2:
        return lat[0] * 1e3 if lat else None
    return statistics.quantiles(lat, n=100, method="inclusive")[94] * 1e3
