"""launches_per_iter.cyclegan: readers.launches_per_iter over the cyclegan training cell."""

from portbench.readers import launches_per_iter as read  # noqa: F401
