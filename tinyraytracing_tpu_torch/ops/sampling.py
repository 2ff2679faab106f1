"""Sampling constants shared by the shading helpers (the parts of
``tinyraytracing_tpu/ops/sampling.py`` the forward slice uses)."""

from __future__ import annotations

import math

PI = math.pi
