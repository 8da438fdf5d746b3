"""Data loading of the port (cf. ``sloika_tpu/data``)."""
