"""launches_per_iter.unet: readers.launches_per_iter over the unet training cell."""

from portbench.readers import launches_per_iter as read  # noqa: F401
