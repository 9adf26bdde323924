"""launches.student_d.unet: spans.launches_student_d over the unet training cell."""

from portbench.spans import launches_student_d as read  # noqa: F401
