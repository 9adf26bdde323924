"""launches.teacher_d.cyclegan: spans.launches_teacher_d over the cyclegan training cell."""

from portbench.spans import launches_teacher_d as read  # noqa: F401
