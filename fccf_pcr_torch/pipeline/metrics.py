"""Registration quality metrics: RRE / RTE against ground truth (port of
``fccf_pcr_tpu/pipeline/metrics.py``)."""

from __future__ import annotations

from ..ops import geometry


def registration_errors(T_est, T_gt):
    """Returns (rre_deg, rte_m); broadcasts over leading batch dims."""
    rre = geometry.rotation_error_deg(T_est[..., :3, :3], T_gt[..., :3, :3])
    rte = geometry.translation_error(T_est[..., :3, 3], T_gt[..., :3, 3])
    return rre, rte
