"""Utilities: structured logging, timing, render checkpointing, reports."""

from tinyraytracing_tpu_torch.utils.logging import get_logger
from tinyraytracing_tpu_torch.utils.timing import Timer

__all__ = ["Timer", "get_logger"]
