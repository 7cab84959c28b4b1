"""One reader per per-layer metric, ``<metric name>.py`` with ``read(run)``:
the value from the run's record, or None where the run has nothing to read."""
