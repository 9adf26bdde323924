"""b2_roofline: readers.b2_roofline."""

from portbench.readers import b2_roofline as read  # noqa: F401
