"""train_mfu.cyclegan: readers.train_mfu over the cyclegan training cell."""

from portbench.readers import train_mfu as read  # noqa: F401
