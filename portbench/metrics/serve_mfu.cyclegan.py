"""serve_mfu.cyclegan: readers.serve_mfu."""

from portbench.readers import serve_mfu as read  # noqa: F401
