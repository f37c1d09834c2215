"""raytracinginonesemester_tpu_torch: the PyTorch/CUDA port of the renderer.

A second package beside the JAX reference ``raytracinginonesemester_tpu``,
with the same module paths and public names.  It imports ``torch`` and
never ``jax``.  The path tracer runs through hand-written CUDA kernels
(``csrc/megakernel.cu``, ``csrc/segment_accum.cu``) on a CUDA device and
through their plain PyTorch versions on the CPU.

- ``core``   — vec math, camera, bit-compatible RNG
- ``io``     — OBJ loading, PNG/PPM codecs (copied from the JAX package)
- ``scene``  — scene configs, transforms, materials/lights, scene building
- ``ops``    — block grid, LBVH and its stack walk, wavefront kernels and
  their scheduling
- ``render`` — whole-image renders, progressive rendering, the CLI
- ``diff``   — differentiable rendering, inverse optimisation, the soft
  renderer and checkpoints
- ``utils``  — metrics logging, device timing and the host spans
- ``viz``    — AABB wireframe export, stage preview, BVH viewer
"""

__version__ = "0.1.0"

from .core.camera import Camera
from .render.renderer import render_hw1, render_scene, render_scene_frames
from .scene.build import Scene, build_scene, load_scene, scene_from_numpy
from .scene.config import SceneConfig, load_scene_config

__all__ = [
    "Camera",
    "Scene",
    "SceneConfig",
    "build_scene",
    "load_scene",
    "load_scene_config",
    "render_hw1",
    "render_scene",
    "render_scene_frames",
    "scene_from_numpy",
]
