"""idle_ms.arch.unet: spans.idle_ms_arch over the unet training cell."""

from portbench.spans import idle_ms_arch as read  # noqa: F401
