"""idle_ms.teacher_d.unet: spans.idle_ms_teacher_d over the unet training cell."""

from portbench.spans import idle_ms_teacher_d as read  # noqa: F401
