"""b2_ms_per_iter: readers.b2_ms_per_iter."""

from portbench.readers import b2_ms_per_iter as read  # noqa: F401
