"""step_host_ms.unet: spans.step_host_ms over the unet training cell."""

from portbench.spans import step_host_ms as read  # noqa: F401
