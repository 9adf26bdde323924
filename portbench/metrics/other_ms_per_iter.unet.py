"""other_ms_per_iter.unet: readers.other_ms_per_iter over the unet training cell."""

from portbench.readers import other_ms_per_iter as read  # noqa: F401
