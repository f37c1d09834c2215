"""Interactive BVH wireframe viewer (PyVista), with a headless fallback.

Port of ``raytracinginonesemester_tpu.viz.view_bvh``. Counterpart of the
reference's ``GPUandCPU/visualize_bvh.py:6-126``: load an AABB-wireframe
OBJ (from ``viz.bvh_export``), tag each box (12 lines) with its node id,
and expose start/end node-range sliders so internal vs leaf levels can
be inspected (leaves of a 2P-1 LBVH start at index P-1,
``bvh.cu:30-31``).

PyVista is optional; without it (or with ``--headless``) the viewer
renders a matplotlib 3D line plot to a PNG instead, keeping the workflow
usable in CI.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

__all__ = ["load_wireframe_obj", "view", "main"]


def load_wireframe_obj(path: str):
    """Parse a v/l wireframe OBJ -> (vertices (V,3), lines (E,2) 0-based)."""
    verts, lines = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif parts[0] == "l":
                idx = [int(p) - 1 for p in parts[1:]]
                for a, b in zip(idx[:-1], idx[1:]):
                    lines.append([a, b])
    return np.asarray(verts, np.float64), np.asarray(lines, np.int64)


def _view_matplotlib(path: str, out_png: str, start: int, end: int):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    verts, lines = load_wireframe_obj(path)
    n_boxes = len(lines) // 12
    end = n_boxes - 1 if end < 0 else min(end, n_boxes - 1)
    sel = lines[start * 12 : (end + 1) * 12]

    fig = plt.figure(figsize=(10, 10))
    ax = fig.add_subplot(111, projection="3d")
    for a, b in sel:
        seg = verts[[a, b]]
        ax.plot(seg[:, 0], seg[:, 1], seg[:, 2], color="limegreen", linewidth=0.5)
    ax.set_title(f"BVH nodes [{start}, {end}] of {n_boxes}")
    fig.savefig(out_png, dpi=120)
    print(f"wrote {out_png} ({n_boxes} boxes, showing [{start}, {end}])")


def _view_pyvista(path: str):
    import pyvista as pv

    mesh = pv.read(path)
    n_boxes = mesh.n_cells // 12
    node_ids = np.repeat(np.arange(n_boxes), 12)[: mesh.n_cells]
    mesh.cell_data["Node ID"] = node_ids
    p_est = (n_boxes + 1) // 2
    print(f"{n_boxes} AABBs; internal [0, {p_est - 2}], leaves [{p_est - 1}, {n_boxes - 1}]")

    plotter = pv.Plotter()
    state = {"lo": 0, "hi": n_boxes - 1}

    def refresh():
        sub = mesh.threshold([state["lo"], state["hi"]], scalars="Node ID")
        plotter.clear_actors()
        plotter.add_mesh(sub, color="lime", style="wireframe", line_width=1)

    refresh()
    plotter.add_axes()
    plotter.show_grid()
    plotter.add_slider_widget(
        lambda v: (state.update(lo=int(v)), refresh()),
        [0, n_boxes - 1], value=0, title="Start Node Index",
        pointa=(0.025, 0.1), pointb=(0.25, 0.1),
    )
    plotter.add_slider_widget(
        lambda v: (state.update(hi=int(v)), refresh()),
        [0, n_boxes - 1], value=n_boxes - 1, title="End Node Index",
        pointa=(0.025, 0.25), pointb=(0.25, 0.25),
    )
    plotter.show()


def view(path: str, headless: bool = False, out_png: str = "bvh_view.png",
         start: int = 0, end: int = -1):
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if not headless:
        try:
            _view_pyvista(path)
            return
        except ImportError:
            print("pyvista not available; falling back to matplotlib PNG")
    _view_matplotlib(path, out_png, start, end)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("obj", nargs="?", default="bvh.obj")
    ap.add_argument("--headless", action="store_true")
    ap.add_argument("--out", default="bvh_view.png")
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--end", type=int, default=-1)
    args = ap.parse_args(argv)
    view(args.obj, args.headless, args.out, args.start, args.end)


if __name__ == "__main__":
    main()
