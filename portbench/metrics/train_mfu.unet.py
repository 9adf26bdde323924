"""train_mfu.unet: readers.train_mfu over the unet training cell."""

from portbench.readers import train_mfu as read  # noqa: F401
