"""One reader per per-layer metric, ``<metric name>.py`` with ``read(r)``
(:mod:`portbench.common.readout`)."""
