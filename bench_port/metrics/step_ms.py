"""``step_ms``: the window's wall time over every optimizer step
completed in it."""


def read(record: dict, name: str):
    if record["unit"] != "step" or not record["units"]:
        return None
    return record["window_s"] * 1e3 / record["units"]
