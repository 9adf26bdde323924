"""serve_launches_per_request.unet: readers.serve_launches_per_request."""

from portbench.readers import serve_launches_per_request as read  # noqa: F401
