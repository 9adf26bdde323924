"""launches.student_d.cyclegan: spans.launches_student_d over the cyclegan training cell."""

from portbench.spans import launches_student_d as read  # noqa: F401
