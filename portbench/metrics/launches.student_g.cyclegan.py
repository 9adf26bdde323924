"""launches.student_g.cyclegan: spans.launches_student_g over the cyclegan training cell."""

from portbench.spans import launches_student_g as read  # noqa: F401
