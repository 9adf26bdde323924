"""step_host_ms.cyclegan: spans.step_host_ms over the cyclegan training cell."""

from portbench.spans import step_host_ms as read  # noqa: F401
