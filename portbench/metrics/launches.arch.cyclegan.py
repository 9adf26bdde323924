"""launches.arch.cyclegan: spans.launches_arch over the cyclegan training cell."""

from portbench.spans import launches_arch as read  # noqa: F401
