"""Percent of the traced span in which no operation ran on the device:
one less the union of every device operation's interval over the span,
from the first one's start to the last one's end."""

from benchmark.harness.readers import idle_share as read  # noqa: F401
