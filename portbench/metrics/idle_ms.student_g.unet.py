"""idle_ms.student_g.unet: spans.idle_ms_student_g over the unet training cell."""

from portbench.spans import idle_ms_student_g as read  # noqa: F401
