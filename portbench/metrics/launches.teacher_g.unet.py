"""launches.teacher_g.unet: spans.launches_teacher_g over the unet training cell."""

from portbench.spans import launches_teacher_g as read  # noqa: F401
