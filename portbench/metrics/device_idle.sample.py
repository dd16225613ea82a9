"""device_idle.sample: 1 - the union of kernel intervals over the traced window."""

from portbench.trace import idle_percent as read  # noqa: F401
