"""LPIPS 2AFC training of the linear heads (mhada_tpu/evals/
lpips_trainer.py:1-119; the vendored lpips/trainer.py).

The heads (clamped to >= 0 after each step, trainer.py:104-107) learn
through a BCE ranking loss on a Dist2LogitLayer (lpips/lpips.py:196-236):
logit = MLP([d0, d1, d0 - d1, d0 / (d1 + eps), d1 / (d0 + eps)]) with
leaky ReLU 0.2 and a sigmoid, target = judge.  Adam(lr=1e-4, betas=(0.5,
0.999)) (trainer.py:21,71); its eps sits outside the square root as
optax's does, so the two take the same steps.  The VGG16 trunk stays
frozen.  A 2AFC sample is (ref, p0, p1, judge in [0, 1]), judge being the
share of people who find p1 closer; images are (B, H, W, 3) RGB 0-255.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.pad_conv import no_tf32
from .lpips import LPIPS_CHANNELS, VGG16Features, distance_from_taps, prep


class Dist2Logit(nn.Module):
    """The 2AFC head (lpips.py:196-224): three linear layers on the five
    distance features; weights U(-1/sqrt(fan_in), 1/sqrt(fan_in)) from
    ``generator``, biases 0 (mhada_tpu/evals/lpips_trainer.py:30-44)."""

    def __init__(self, chn_mid: int = 32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.l1 = nn.Linear(5, chn_mid)
        self.l2 = nn.Linear(chn_mid, chn_mid)
        self.l3 = nn.Linear(chn_mid, 1)
        with torch.no_grad():
            for lin in (self.l1, self.l2, self.l3):
                bound = lin.in_features ** -0.5
                lin.weight.uniform_(-bound, bound, generator=generator)
                lin.bias.zero_()

    def forward(self, d0: torch.Tensor, d1: torch.Tensor,
                eps: float = 0.1) -> torch.Tensor:
        """The probability that p1 is the closer one, (B,)."""
        x = torch.stack([d0, d1, d0 - d1, d0 / (d1 + eps), d1 / (d0 + eps)],
                        dim=-1)
        h = F.leaky_relu(self.l1(x), 0.2)
        h = F.leaky_relu(self.l2(h), 0.2)
        return torch.sigmoid(self.l3(h)[..., 0])


class LPIPSTrainer:
    """The heads, the 2AFC head and their Adam state, on the trunk's
    device.  The heads start at 1/C each (make_lpips_trainer's init)."""

    def __init__(self, trunk: VGG16Features, lr: float = 1e-4,
                 beta1: float = 0.5,
                 generator: torch.Generator | None = None):
        self.trunk = trunk.eval().requires_grad_(False)
        self.device = next(trunk.parameters()).device
        self.lins = [torch.full((c,), 1.0 / c, device=self.device,
                                requires_grad=True) for c in LPIPS_CHANNELS]
        self.logit = Dist2Logit(generator=generator).to(self.device)
        self.opt = torch.optim.Adam([*self.lins, *self.logit.parameters()],
                                    lr=lr, betas=(beta1, 0.999))

    def _taps(self, img: torch.Tensor) -> list[torch.Tensor]:
        with torch.no_grad():
            return self.trunk(prep(img.to(self.device)))

    def distance(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        """LPIPS with the current heads, (B,)."""
        with torch.no_grad(), no_tf32():
            return distance_from_taps(self._taps(img0), self._taps(img1),
                                      self.lins)

    def step(self, ref: torch.Tensor, p0: torch.Tensor, p1: torch.Tensor,
             judge: torch.Tensor) -> dict[str, float]:
        """One Adam step on a batch -> the batch's loss and 2AFC accuracy
        (d1 < d0 agreeing with judge > 0.5), both before the update."""
        judge = judge.to(self.device)
        with no_tf32():
            fr = self._taps(ref)
            d0 = distance_from_taps(fr, self._taps(p0), self.lins)
            d1 = distance_from_taps(fr, self._taps(p1), self.lins)
            prob = self.logit(d0, d1)
            bce = -(judge * torch.log(prob + 1e-12)
                    + (1 - judge) * torch.log(1 - prob + 1e-12))
            loss = bce.mean()
            self.opt.zero_grad()
            loss.backward()
            self.opt.step()
        with torch.no_grad():
            for w in self.lins:
                w.clamp_(min=0.0)
            acc = ((d1 < d0) == (judge > 0.5)).float().mean()
        return {"loss": float(loss.detach()), "acc": float(acc)}
