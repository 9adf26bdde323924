"""idle_ms.teacher_g.unet: spans.idle_ms_teacher_g over the unet training cell."""

from portbench.spans import idle_ms_teacher_g as read  # noqa: F401
