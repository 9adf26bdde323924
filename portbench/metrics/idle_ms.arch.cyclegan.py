"""idle_ms.arch.cyclegan: spans.idle_ms_arch over the cyclegan training cell."""

from portbench.spans import idle_ms_arch as read  # noqa: F401
