"""launches.teacher_g.cyclegan: spans.launches_teacher_g over the cyclegan training cell."""

from portbench.spans import launches_teacher_g as read  # noqa: F401
