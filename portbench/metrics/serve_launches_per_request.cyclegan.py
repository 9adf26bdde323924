"""serve_launches_per_request.cyclegan: readers.serve_launches_per_request."""

from portbench.readers import serve_launches_per_request as read  # noqa: F401
