"""The benchmark's windows, one module an entry: ``Entry(run)`` sets the
cell up and warms it, ``call()`` drives the program once and returns the
units of work it did, ``keep(i)`` keeps what the check compares of call
``i``, ``release()`` frees the program's state, ``check(dtype)`` compares
with the reference computed in ``dtype``, and ``control()`` puts the
reference in the program's place in a lower precision.  ``harness_s``,
where an entry keeps it, is the time its own work took inside the
window."""
