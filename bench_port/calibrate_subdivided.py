"""``calibrate.py`` for the cells of the ``render_subdivided`` entry.

    python3 bench_port/calibrate_subdivided.py --workload frog_large_1080p.wavefront --seeds 1 2 ... [--control 3]

``calibrate.py`` keys its faults on the entry's name; this entry's
window is ``render_frames``' (it calls ``render_scene_frames``), so it
takes the same faults, planted the same way.  The readings are
``calibrate.py``'s, appended to ``bench_port/out/calibrate_<cell>.jsonl``.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_port import calibrate  # noqa: E402

_planted = calibrate.planted


def planted(fault: str, entry: str = "train_step"):
    return _planted(fault, "render_frames" if entry == "render_subdivided"
                    else entry)


if __name__ == "__main__":
    calibrate.FAULTS["render_subdivided"] = calibrate.FAULTS["render_frames"]
    calibrate.planted = planted
    sys.exit(calibrate.main())
