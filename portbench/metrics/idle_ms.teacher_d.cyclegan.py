"""idle_ms.teacher_d.cyclegan: spans.idle_ms_teacher_d over the cyclegan training cell."""

from portbench.spans import idle_ms_teacher_d as read  # noqa: F401
