"""Plain references that decide ``correct``, one module per family of
configurations, named by a configuration's ``"reference"`` key. Each has
``answers(config, pool, device)`` (float64 answers for each position of
a pool that cycles: ``audio`` and the carried state) and
``control_step(config, device)`` (the reference one precision lower, in
the program's place). None imports the port, JAX or the JAX package."""
