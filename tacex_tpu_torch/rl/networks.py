"""Actor-critic networks for dict observations, forward pass (PyTorch).

Port of ``tacex_tpu/rl/networks.py``: vision -> conv(16, k4, s2) ->
conv(4, k3, s1) -> flatten -> concat(proprio) -> MLP [256, 128, 64] (elu) ->
gaussian policy head / value head, with separate policy and value towers.
Observations keep the JAX layout (NHWC images); the conv output is flattened
in NHWC order, so weights converted by ``actor_critic_from_flax`` give the
JAX network's outputs.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _conv_out(size: int, k: int, s: int) -> int:
    return (size - k) // s + 1


class VisionEncoder(nn.Module):
    def __init__(self, in_channels: int, device=None):
        super().__init__()
        self.conv0 = nn.Conv2d(in_channels, 16, 4, stride=2, device=device)
        self.conv1 = nn.Conv2d(16, 4, 3, stride=1, device=device)

    @staticmethod
    def out_features(h: int, w: int) -> int:
        return _conv_out(_conv_out(h, 4, 2), 3, 1) * _conv_out(_conv_out(w, 4, 2), 3, 1) * 4

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, H, W, C)
        x = torch.relu(self.conv0(x.permute(0, 3, 1, 2)))
        x = torch.relu(self.conv1(x))
        return x.permute(0, 2, 3, 1).flatten(1)  # NHWC order


class ActorCritic(nn.Module):
    """Gaussian actor + value critic over ``{"proprio_obs", "vision_obs"}``."""

    def __init__(
        self,
        proprio_dim: int,
        vision_shape: tuple[int, int, int],  # (h, w, c)
        action_dim: int,
        hidden: tuple = (256, 128, 64),
        initial_log_std: float = 0.0,
        min_log_std: float = -20.0,
        max_log_std: float = 2.0,
        device=None,
    ):
        super().__init__()
        self.min_log_std, self.max_log_std = min_log_std, max_log_std
        h, w, c = vision_shape
        self.pi_encoder = VisionEncoder(c, device=device)
        self.v_encoder = VisionEncoder(c, device=device)
        in_dim = proprio_dim + VisionEncoder.out_features(h, w)

        def tower():
            layers, d = [], in_dim
            for hd in hidden:
                layers += [nn.Linear(d, hd, device=device), nn.ELU()]
                d = hd
            return nn.Sequential(*layers)

        self.pi_tower = tower()
        self.v_tower = tower()
        self.mean_head = nn.Linear(hidden[-1], action_dim, device=device)
        self.value_head = nn.Linear(hidden[-1], 1, device=device)
        self.log_std = nn.Parameter(torch.full((action_dim,), float(initial_log_std), device=device))

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> "ActorCritic":
        """Draw the weights from ``generator``: lecun-normal kernels, zero
        biases, and a 0.01-scaled mean head, as the JAX network starts."""
        for name, p in self.named_parameters():
            if name == "log_std":
                continue
            if name.endswith("bias"):
                p.zero_()
                continue
            fan_in = p[0].numel()
            scale = 0.01 if name.startswith("mean_head") else 1.0
            draw = torch.randn(p.shape, generator=generator, device=generator.device)
            p.copy_(draw * (scale / fan_in**0.5))
        return self

    @staticmethod
    def _features(encoder, obs):
        return torch.cat([encoder(obs["vision_obs"]), obs["proprio_obs"]], dim=-1)

    def forward(self, obs: dict[str, torch.Tensor]):
        pol = self.pi_tower(self._features(self.pi_encoder, obs))
        val = self.v_tower(self._features(self.v_encoder, obs))
        mean = self.mean_head(pol)
        log_std = torch.clamp(self.log_std, self.min_log_std, self.max_log_std).expand_as(mean)
        value = self.value_head(val)[..., 0]
        return mean, log_std, value


def actor_critic_from_flax(params) -> dict[str, torch.Tensor]:
    """``ActorCritic`` state_dict from the JAX network's params (numpy leaves).

    Flax names the towers' layers in call order: ``VisionEncoder_0`` and
    ``Dense_0..2`` for the policy, ``VisionEncoder_1`` and ``Dense_3..5`` for
    the value, then ``Dense_6`` (mean) and ``Dense_7`` (value). Conv kernels
    go from HWIO to OIHW; Dense kernels (in, out) are transposed.
    """
    p = params.get("params", params)
    t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32, copy=True))
    dense = sorted((k for k in p if k.startswith("Dense_")), key=lambda k: int(k.split("_")[1]))
    n_hidden = (len(dense) - 2) // 2
    sd = {}
    for prefix, names in (("pi_tower", dense[:n_hidden]), ("v_tower", dense[n_hidden : 2 * n_hidden])):
        for i, name in enumerate(names):
            sd[f"{prefix}.{2 * i}.weight"] = t(p[name]["kernel"]).T.contiguous()
            sd[f"{prefix}.{2 * i}.bias"] = t(p[name]["bias"])
    for prefix, name in (("mean_head", dense[-2]), ("value_head", dense[-1])):
        sd[f"{prefix}.weight"] = t(p[name]["kernel"]).T.contiguous()
        sd[f"{prefix}.bias"] = t(p[name]["bias"])
    for prefix, name in (("pi_encoder", "VisionEncoder_0"), ("v_encoder", "VisionEncoder_1")):
        for i in range(2):
            conv = p[name][f"Conv_{i}"]
            sd[f"{prefix}.conv{i}.weight"] = t(conv["kernel"]).permute(3, 2, 0, 1).contiguous()
            sd[f"{prefix}.conv{i}.bias"] = t(conv["bias"])
    sd["log_std"] = t(p["log_std"])
    return sd
