"""One module an entry kind, named by a traffic mix's ``"entry"``: its
``run(cell, args, device, t_start)`` builds what the window drives from
the run's seed, runs the window (and with ``--trace 1`` a profiled slice),
and judges the outputs against the plain reference. It returns the
measured end-to-end quantities by name, the per-layer readings, and the
numbers compared. A new entry kind is a new file here."""
