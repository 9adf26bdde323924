"""idle_ms.student_d.unet: spans.idle_ms_student_d over the unet training cell."""

from portbench.spans import idle_ms_student_d as read  # noqa: F401
