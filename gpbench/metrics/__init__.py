"""Per-layer metric readers: ``<metric name>.py`` holds ``read(data)``, which
takes the traced run's data (an entry's ``trace()``) and returns the metric's
value, or None where it finds nothing to read (the metric is then left out
of the result line). A share of a roofline or of a peak is never made up:
None, not 0, where its parts are missing."""
