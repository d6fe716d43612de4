"""The port's operator and analyzer tools, each a module run from the
repository root as ``python -m uigc_tpu_torch.tools.<name>``:

``uigc_check``      the whole-repo static checker (analysis/check/)
``uigc_lint``       its lint pass alone
``telemetry_dump``  Prometheus text / JSON / series / device renders
``graph_inspect``   why-live paths, snapshots, diffs, a self-check
``uigc_top``        the live ops dashboard
``device_report``   the device observatory's wake-budget report
``sweep_profile``   the propagate trace's per-sweep cost decomposition

Copies of the reference's ``tools/`` of the same names; they import
only the port.  ``--demo`` and the profile run on the CUDA card unless
``--device cpu`` is passed.
"""
