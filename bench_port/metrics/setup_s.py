"""``setup_s``: from the start of the process, before ``torch`` loads, to
the start of the window: loading, building, the plan, the calibration,
the warm-up."""


def read(record: dict, name: str):
    return record["setup_s"]
