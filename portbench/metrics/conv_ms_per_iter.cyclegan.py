"""conv_ms_per_iter.cyclegan: readers.conv_ms_per_iter over the cyclegan training cell."""

from portbench.readers import conv_ms_per_iter as read  # noqa: F401
