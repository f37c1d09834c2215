"""Offline scene stage preview.

Port of ``raytracinginonesemester_tpu.viz.stage_preview`` on this
package's camera, OBJ loader and transforms. Counterpart of the
reference's Polyscope ``StagePreview``
(``CPUOnly/src/stage_preview.cpp:24-186``): visualize the camera center,
the pixel grid in world space, the camera->pixel ray network, every
scene mesh (with its transform baked), the light position, and the world
axes (``HW1/include/visualization.h:15-71``). Rendered headlessly with
matplotlib to a PNG -- the same inspection workflow without a windowed
UI. """

from __future__ import annotations

import numpy as np

__all__ = ["stage_preview"]


def stage_preview(
    config,
    scene_path: str = ".",
    out_png: str = "stage_preview.png",
    grid_step: int = 8,
    max_mesh_edges: int = 4000,
):
    """Render a stage preview PNG for a loaded SceneConfig.

    ``grid_step`` subsamples the pixel grid (the reference draws every
    pixel; at 1080p that is illegible anyway).
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..core.camera import Camera
    from ..io.obj import load_obj
    from ..scene.config import resolve_mesh_path
    from ..scene.transform import transform_points

    cam = Camera.create(
        position=config.camera_position,
        look_at=config.camera_look_at,
        up=config.camera_up,
        focal_length_mm=config.focal_length_mm,
        sensor_height_mm=config.sensor_height_mm,
        sensor_width_mm=config.sensor_width_mm,
        width=config.pixel_width,
        height=config.pixel_height,
        device="cpu",
    )

    fig = plt.figure(figsize=(11, 11))
    ax = fig.add_subplot(111, projection="3d")

    # world axes (viz::register_axes, visualization.h:46-63)
    for axis, color in zip(np.eye(3), ("r", "g", "b")):
        seg = np.stack([np.zeros(3), axis * 0.5])
        ax.plot(seg[:, 0], seg[:, 1], seg[:, 2], color=color, linewidth=2)

    # pixel grid + ray network (stage_preview.cpp:24-60)
    ii, jj = np.meshgrid(
        np.arange(0, config.pixel_width, grid_step),
        np.arange(0, config.pixel_height, grid_step),
    )
    pix = cam.pixel_position(ii.ravel(), jj.ravel()).numpy()
    ax.scatter(pix[:, 0], pix[:, 1], pix[:, 2], s=1, c="steelblue", alpha=0.6)
    center = cam.center.numpy()
    for p in pix[:: max(1, len(pix) // 64)]:
        seg = np.stack([center, p])
        ax.plot(seg[:, 0], seg[:, 1], seg[:, 2], color="gray",
                linewidth=0.3, alpha=0.4)
    ax.scatter(*center, s=60, c="black", marker="^", label="camera")

    # scene meshes with transforms baked (stage_preview.cpp:80-118)
    for node in config.nodes:
        if node.type and node.type != "mesh":
            continue
        try:
            mesh, _ = load_obj(resolve_mesh_path(scene_path, node.path))
        except (FileNotFoundError, ValueError):
            continue
        pos = transform_points(node.transform, mesh.positions)
        idx = mesh.indices.reshape(-1, 3)
        stride = max(1, len(idx) // max_mesh_edges)
        for tri in idx[::stride]:
            closed = pos[[tri[0], tri[1], tri[2], tri[0]]]
            ax.plot(closed[:, 0], closed[:, 1], closed[:, 2],
                    color="olive", linewidth=0.3, alpha=0.5)

    # lights (stage_preview.cpp:168-174)
    for light in config.lights:
        lp = np.asarray(light["position"])
        ax.scatter(*lp, s=80, c="gold", marker="*", label="light")

    ax.set_xlabel("x"); ax.set_ylabel("y"); ax.set_zlabel("z")
    ax.set_title("stage preview")
    fig.savefig(out_png, dpi=120)
    plt.close(fig)
    return out_png
