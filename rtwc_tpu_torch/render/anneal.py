"""Temperature annealing for the differentiable renderer.

Counterpart: rtwc_tpu/render/anneal.py, the same dataclass and arithmetic
(pure Python; the config dataclass is shared with the JAX package).

SURVEY.md section 7 lists the temperature schedule as a known hard part of
the soft-renderer design: large tau (and gentle hinge/shadow sharpness)
gives silhouette gradients with long range but blurry geometry; the
display-sharp settings (tau -> 0, k -> inf, converging on the reference's
hard branches, Sphere.cu:42-60 / RayTracing.cu:123-135) have near-zero
gradient support. The standard cure is a coarse-to-fine ladder: optimize
at a soft temperature, then re-sharpen and continue from the previous
stage's solution, ending at display-sharp settings.

tau / soft_mask_k / soft_shadow_k are constants of a kernel launch (its
params struct), so a schedule is a ladder of discrete stages, not a
per-step traced value. Geometric interpolation keeps
the relative sharpening per stage constant, which is the natural scale for
temperatures.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterator, Tuple

from rtwc_tpu_torch.config import RenderConfig


@dataclasses.dataclass(frozen=True)
class AnnealSchedule:
    """Geometric coarse-to-fine ladder over the softness constants.

    Stage i of n interpolates each constant geometrically from its *0
    (coarse) to *1 (sharp) value: x_i = x0 * (x1/x0)^(i/(n-1)).
    """

    n_stages: int = 5
    tau0: float = 20.0
    tau1: float = 0.05
    # tau is the ONE safe coarse knob. An object influences pixels whose
    # constraint violation Delta satisfies penalty * Delta < ~16 * tau
    # (softmin weight floor exp(-16)), so raising tau widens the
    # silhouette pull-in range; tau0=20, penalty=300 -> ~1 world unit.
    # Lowering the penalty instead is a trap (measured, round 3): an
    # object beats the far-plane background logit out to
    # (far - t_hit) / penalty world units, so penalty=8 paints halos over
    # the whole image and the fit diverges. Keep penalty (and the hinge
    # sharpness k) constant unless you know the geometry is near-converged.
    penalty0: float = 300.0
    penalty1: float = 300.0
    mask_k0: float = 10.0
    mask_k1: float = 10.0
    shadow_k0: float = 10.0
    shadow_k1: float = 10.0

    def __post_init__(self):
        if self.n_stages < 1:
            raise ValueError("n_stages must be >= 1")
        for lo, hi, name in ((self.tau0, self.tau1, "tau"),
                             (self.penalty0, self.penalty1, "penalty"),
                             (self.mask_k0, self.mask_k1, "mask_k"),
                             (self.shadow_k0, self.shadow_k1, "shadow_k")):
            if lo <= 0 or hi <= 0:
                raise ValueError(f"{name} endpoints must be positive")

    def _interp(self, lo: float, hi: float, i: int) -> float:
        if self.n_stages == 1:
            return hi
        t = i / (self.n_stages - 1)
        return lo * math.exp(t * math.log(hi / lo))

    def stage(self, i: int) -> Tuple[float, float, float, float]:
        """(tau, soft_miss_penalty, soft_mask_k, soft_shadow_k) for stage i."""
        if not 0 <= i < self.n_stages:
            raise IndexError(i)
        return (self._interp(self.tau0, self.tau1, i),
                self._interp(self.penalty0, self.penalty1, i),
                self._interp(self.mask_k0, self.mask_k1, i),
                self._interp(self.shadow_k0, self.shadow_k1, i))

    def configs(self, config: RenderConfig) -> Iterator[Tuple[float, RenderConfig]]:
        """Yield (tau, stage_config) pairs, coarse to sharp."""
        for i in range(self.n_stages):
            tau, penalty, mask_k, shadow_k = self.stage(i)
            yield tau, config.replace(soft_miss_penalty=penalty,
                                      soft_mask_k=mask_k,
                                      soft_shadow_k=shadow_k)

    def split_steps(self, total: int) -> list[int]:
        """Partition a step budget across stages (equal shares, remainder
        to the earliest - coarsest - stages, which move parameters the
        furthest)."""
        base, rem = divmod(max(total, self.n_stages), self.n_stages)
        return [base + (1 if i < rem else 0) for i in range(self.n_stages)]
