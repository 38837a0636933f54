"""Profiler range annotations: NVTX ranges on the card, no-ops elsewhere.

The reference's ``NvtxRange`` pushed an NVTX range through JNI
(``NvtxRange.java:37-59``, ``rapidsml_jni.cu:82-105``). Here a range is a
context manager over ``torch.cuda.nvtx`` when a CUDA device is present, so
it shows in any CUDA profiler's timeline; without a card it does nothing.
The 9-color palette mirrors ``NvtxColor.java:20-29`` and the JAX package's
``TraceColor``; ``torch.cuda.nvtx`` has no color channel, so the color is
advisory metadata.
"""

from __future__ import annotations

import enum

import torch


class TraceColor(enum.Enum):
    """ARGB color bits, same palette as the reference's NvtxColor."""

    GREEN = 0xFF76B900
    BLUE = 0xFF0071C5
    PURPLE = 0xFF7F00FF
    YELLOW = 0xFFFFFF00
    RED = 0xFFFF0000
    WHITE = 0xFFFFFFFF
    DARK_GREEN = 0xFF004D00
    ORANGE = 0xFFFFA500
    CYAN = 0xFF00FFFF


class TraceRange:
    """Context manager: ``with TraceRange("compute cov", TraceColor.RED): ...``"""

    def __init__(self, name: str, color: TraceColor = TraceColor.WHITE):
        self.name = name
        self.color = color
        self._nvtx = False

    def __enter__(self) -> "TraceRange":
        self._nvtx = torch.cuda.is_available()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
