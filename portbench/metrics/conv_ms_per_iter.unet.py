"""conv_ms_per_iter.unet: readers.conv_ms_per_iter over the unet training cell."""

from portbench.readers import conv_ms_per_iter as read  # noqa: F401
