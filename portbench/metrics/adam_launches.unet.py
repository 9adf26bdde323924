"""adam_launches.unet: spans.adam_launches over the unet training cell."""

from portbench.spans import adam_launches as read  # noqa: F401
