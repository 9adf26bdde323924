"""adam_launches.cyclegan: spans.adam_launches over the cyclegan training cell."""

from portbench.spans import adam_launches as read  # noqa: F401
