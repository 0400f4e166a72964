"""The benchmark's own library: generators, the plain reference, the
comparison that decides ``correct``, spans, trace reduction and the
table of peaks.  Nothing here imports the JAX package; only
``program.py``, ``faults.py`` and the drivers touch the program under
test."""
