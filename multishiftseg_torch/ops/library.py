"""Registers every custom op of the port (namespace ``mss``): import this
module before loading an exported program that calls them.

- ``mss::ms_deform_attn`` (``bilinear`` / ``nearest``), ``mss::ms_deform_attn_backward``,
  ``mss::ms_deform_attn_quantize``, ``mss::ms_deform_attn_int8_table``,
  ``mss::ms_deform_attn_approx`` (``nearest_top{T}``, ``nearest_top{T}c``,
  ``shared``): ``ops/ms_deform_attn.py``;
- ``mss::mask_scores`` (the anomaly and both semantic tails),
  ``mss::mask_scores_backward``: ``ops/scores.py``;
- ``mss::dilated_conv3x3``, ``mss::dilated_conv3x3_backward``: ``ops/dilated_conv.py``.
"""

from . import NAMESPACE, dilated_conv, ms_deform_attn, scores  # noqa: F401

OPS = ("ms_deform_attn", "ms_deform_attn_backward", "ms_deform_attn_quantize",
       "ms_deform_attn_int8_table", "ms_deform_attn_approx", "mask_scores",
       "mask_scores_backward", "dilated_conv3x3", "dilated_conv3x3_backward")
