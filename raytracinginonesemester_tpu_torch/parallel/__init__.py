"""Multi-process rendering and training on ``torch.distributed``.

PyTorch port of ``raytracinginonesemester_tpu.parallel``.  The JAX
package runs one controller over a device mesh with ``shard_map``; here
every shard is a process of its own (one rank a device with NCCL, or
ranks on the CPU or sharing one card with gloo), and a mesh is one
process group per axis for each rank (``sharded.Mesh``).  The
collectives are ``ops.comm``'s, which the model axis of
``ops.integrator`` uses too.

- ``sharded``           — ``make_mesh``, ``shard_scene_blocks``,
  ``render_scene_sharded`` (pixels over "data", triangle blocks over a
  model axis) and ``make_train_step_sharded``
- ``wavefront_sharded`` — the compacted dp x tp bounce scheduler
- ``multihost``         — process-group set-up from a launcher's
  environment, and the host x chip mesh
- ``dryrun``            — ``dryrun_multichip``: the three sharded steps
  of the JAX package's dry run, on spawned ranks
"""
