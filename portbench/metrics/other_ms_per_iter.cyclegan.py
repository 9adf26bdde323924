"""other_ms_per_iter.cyclegan: readers.other_ms_per_iter over the cyclegan training cell."""

from portbench.readers import other_ms_per_iter as read  # noqa: F401
