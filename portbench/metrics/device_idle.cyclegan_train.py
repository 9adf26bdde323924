"""device_idle.cyclegan_train: readers.device_idle_train."""

from portbench.readers import device_idle_train as read  # noqa: F401
