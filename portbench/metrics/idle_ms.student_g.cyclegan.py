"""idle_ms.student_g.cyclegan: spans.idle_ms_student_g over the cyclegan training cell."""

from portbench.spans import idle_ms_student_g as read  # noqa: F401
