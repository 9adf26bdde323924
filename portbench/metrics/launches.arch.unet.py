"""launches.arch.unet: spans.launches_arch over the unet training cell."""

from portbench.spans import launches_arch as read  # noqa: F401
