"""idle_ms.student_d.cyclegan: spans.idle_ms_student_d over the cyclegan training cell."""

from portbench.spans import idle_ms_student_d as read  # noqa: F401
