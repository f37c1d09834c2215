"""``frame_ms``: the window's wall time over every frame completed in it."""


def read(record: dict, name: str):
    if record["unit"] != "frame" or not record["units"]:
        return None
    return record["window_s"] * 1e3 / record["units"]
