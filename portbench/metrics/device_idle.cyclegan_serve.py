"""device_idle.cyclegan_serve: readers.device_idle_serve."""

from portbench.readers import device_idle_serve as read  # noqa: F401
