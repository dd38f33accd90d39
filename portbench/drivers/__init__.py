"""Load drivers, one module per kind of traffic; a mix's ``driver`` key
names its module here.  Each module defines ``Driver(cell, system, seed,
plain)``, where ``system`` is what ``Driver.build(config, seed, device,
inference)`` returns (``system.build``'s pipeline where the driver has no
``build``), with ``inference(cell)`` (the inference-config fields the mix
sets), ``warm()``, ``measure(seconds, tracer) -> Record``, ``close()`` and
``samples(seed)`` (what the reference compares), and optionally
``dtype(cell)``, the type the timed work computes in (the configuration's
``dtype`` where the driver has none); the comparison is
``numbers`` in ``portbench/reference/<driver>.py``, a module of its own."""
