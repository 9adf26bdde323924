"""launches.teacher_d.unet: spans.launches_teacher_d over the unet training cell."""

from portbench.spans import launches_teacher_d as read  # noqa: F401
