"""idle_ms.teacher_g.cyclegan: spans.idle_ms_teacher_g over the cyclegan training cell."""

from portbench.spans import idle_ms_teacher_g as read  # noqa: F401
