"""Adaptive steal-proportion control for the executor (PyTorch port of
``repro.runtime.adaptive``).

The master's observed queue sizes feed a small controller that servos the
steal proportion toward ``core.policy.adaptive_chunk``'s idle/busy-ratio
target.  The feedback step is :func:`adaptive_update`, float32 tensor
arithmetic with one source of truth, run in two places:

* on the device, inside ``StealRuntime.run_fused``'s loop, where the
  proportion is a float32 0-d tensor that never leaves the device;
* on the host, via :class:`AdaptiveController`, after each
  ``StealRuntime.round`` — the same float32 computation on CPU tensors,
  so both trajectories are bit-identical to each other and to the JAX
  package's.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.ops import f32_scalar
from repro_torch.core.policy import StealPolicy

__all__ = ["AdaptiveConfig", "AdaptiveController", "adaptive_update"]


@dataclasses.dataclass(frozen=True)
class AdaptiveConfig:
    """Controller bounds and dynamics (the JAX package's defaults).

    Attributes:
      min_proportion / max_proportion: clamp range.
      gain: first-order smoothing toward the target (1.0 = jump straight to
        the target each round).
    """

    min_proportion: float = 0.125
    max_proportion: float = 0.75
    gain: float = 0.5


def adaptive_update(proportion, sizes: torch.Tensor, *,
                    policy: StealPolicy,
                    config: AdaptiveConfig) -> torch.Tensor:
    """One feedback step: float32 scalar in, float32 0-d tensor out, on
    ``sizes``' device.  The target scales the proportion with the
    idle/busy imbalance, clamped to [0.125, 0.75], then first-order
    smooths toward it.  When the plan can pair no (victim, thief) there
    is no transfer to size, so the proportion holds."""
    f32, dev = torch.float32, sizes.device
    p = f32_scalar(proportion, dev)
    n_idle = (sizes <= policy.low_watermark).sum().to(torch.int32)
    n_busy = (sizes >= policy.high_watermark).sum().to(torch.int32)
    ratio = n_idle.to(f32) / torch.clamp(n_idle + n_busy, min=1).to(f32)
    target = torch.clamp(f32_scalar(policy.proportion, dev) * 2.0 * ratio,
                         0.125, 0.75)
    p_new = torch.clamp(p + f32_scalar(config.gain, dev) * (target - p),
                        config.min_proportion, config.max_proportion)
    return torch.where((n_idle > 0) & (n_busy > 0), p_new, p)


class AdaptiveController:
    """Host-side wrapper: history + the NEXT round's proportion.

    Delegates the arithmetic to :func:`adaptive_update` so the host
    trajectory is bit-identical to the on-device fused one.  (The JAX
    package's straggler boost belongs to the fault layer, which is not
    ported yet.)
    """

    def __init__(self, policy: StealPolicy,
                 config: Optional[AdaptiveConfig] = None):
        self.policy = policy
        self.config = config or AdaptiveConfig()
        self.proportion = float(np.float32(policy.proportion))
        self.history: List[float] = [self.proportion]

    def update(self, sizes) -> float:
        """One feedback step from the post-round size vector."""
        p = float(adaptive_update(
            torch.tensor(self.proportion, dtype=torch.float32),
            torch.as_tensor(np.asarray(sizes, np.int32)),
            policy=self.policy, config=self.config))
        self.proportion = p
        self.history.append(p)
        return p

    def absorb(self, proportions_used, final_proportion) -> None:
        """Sync host state after an on-device fused run:
        ``proportions_used`` are the per-round values the loop consumed
        (element 0 is the pre-run proportion already in ``history``),
        ``final_proportion`` the post-run value."""
        post = [float(x) for x in np.asarray(proportions_used)[1:]]
        self.proportion = float(final_proportion)
        self.history.extend(post + [self.proportion])
