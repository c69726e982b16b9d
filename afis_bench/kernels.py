"""The kernel layer's groups, by the device kernels' names.

The screen group holds the serving path's screens (``engine._screen_all``:
``minu_screen*`` and ``adc_screen*``, which run the screen bodies with
latent rows ``LatRows``); the exact group the dense path's kernels
(``engine._match_all``: ``minutiae_match``, the ADC row maximum, whose
launches run the screen body with argmax rows ``ArgRows``, and
``texture_match``), and the graph filters. Every other device operation
(sorts, gathers, copies, masks) belongs to selection and readback.
"""
from __future__ import annotations

EXACT = ("ArgRows", "adc_rowmax", "minutiae_match", "texture_match",
         "graph_filter")
SCREEN = ("LatRows", "minu_screen", "afis_minu::screen_kernel", "screen_t")


def group_of(name: str) -> str:
    if any(k in name for k in EXACT):
        return "exact"
    if any(k in name for k in SCREEN):
        return "screen"
    return "select"


def device_seconds(trace, group: str, kernels_only: bool = True) -> float:
    return sum(s for name, (s, _) in trace.by_name(kernels_only).items()
               if group_of(name) == group)
