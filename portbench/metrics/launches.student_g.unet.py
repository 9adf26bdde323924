"""launches.student_g.unet: spans.launches_student_g over the unet training cell."""

from portbench.spans import launches_student_g as read  # noqa: F401
