"""Dempster-Shafer evidence fusion over per-class detection confidences.

A copy of ``mmidet_tpu/utils/ds_fusion.py``; reference
``utils/ds_fusion.py:1-178``, which imports a ``full_arrange`` that does
not exist and is imported nowhere.  This is a working form of the same
idea: two modalities' class-confidence mass functions combined by
Dempster's rule, with the conflict renormalised.
"""

from __future__ import annotations

import numpy as np


def mass_from_confidences(conf: np.ndarray, uncertainty: float = 0.1
                          ) -> np.ndarray:
    """Class confidences (nc,) -> mass function over nc singletons + Theta
    (last entry = ignorance mass)."""
    conf = np.clip(np.asarray(conf, np.float64), 0, None)
    s = conf.sum()
    if s <= 0:
        m = np.zeros(len(conf) + 1)
        m[-1] = 1.0
        return m
    m = conf / s * (1.0 - uncertainty)
    return np.concatenate([m, [uncertainty]])


def dempster_combine(m1: np.ndarray, m2: np.ndarray) -> np.ndarray:
    """Dempster's rule for singleton frames + Theta."""
    n = len(m1) - 1
    out = np.zeros_like(m1)
    theta1, theta2 = m1[-1], m2[-1]
    # agreement on singletons + singleton x Theta
    for i in range(n):
        out[i] = m1[i] * m2[i] + m1[i] * theta2 + theta1 * m2[i]
    out[-1] = theta1 * theta2
    # conflict: singleton pairs that disagree
    conflict = sum(m1[i] * m2[j] for i in range(n) for j in range(n)
                   if i != j)
    k = 1.0 - conflict
    if k <= 1e-12:
        out = np.zeros_like(m1)
        out[-1] = 1.0
        return out
    return out / k


def fuse_modal_confidences(conf_rgb: np.ndarray, conf_ir: np.ndarray,
                           uncertainty: float = 0.1) -> np.ndarray:
    """Fused per-class belief from two modalities' confidences."""
    m = dempster_combine(mass_from_confidences(conf_rgb, uncertainty),
                         mass_from_confidences(conf_ir, uncertainty))
    return m[:-1] / max(m[:-1].sum(), 1e-12)
