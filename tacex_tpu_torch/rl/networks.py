"""Actor-critic networks for dict observations (PyTorch).

Port of ``tacex_tpu/rl/networks.py``: vision -> conv(16, k4, s2) ->
conv(4, k3, s1) -> flatten -> concat(proprio) -> MLP [256, 128, 64] (elu) ->
gaussian policy head / value head, with separate policy and value towers,
or with ``shared_trunk=True`` one encoder and one tower that both heads
read. Without a vision observation the towers read the proprio vector
alone. Observations keep the JAX layout (NHWC images); the conv
output is flattened in NHWC order, so weights converted by
``actor_critic_from_flax`` give the JAX network's outputs, and
``actor_critic_to_flax`` carries trained weights back.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..core.device import DEFAULT_DEVICE, resolve


def _conv_out(size: int, k: int, s: int) -> int:
    return (size - k) // s + 1


class VisionEncoder(nn.Module):
    def __init__(self, in_channels: int, device=DEFAULT_DEVICE):
        super().__init__()
        device = resolve(device)
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
    """Gaussian actor + value critic over ``{"proprio_obs", "vision_obs"}``,
    or over ``{"proprio_obs"}`` alone when ``vision_shape`` is None. With
    ``shared_trunk`` the value head reads the policy tower (no ``v_encoder``,
    no ``v_tower``)."""

    def __init__(
        self,
        proprio_dim: int,
        vision_shape: tuple[int, int, int] | None,  # (h, w, c)
        action_dim: int,
        hidden: tuple = (256, 128, 64),
        initial_log_std: float = 0.0,
        min_log_std: float = -20.0,
        max_log_std: float = 2.0,
        shared_trunk: bool = False,
        device=DEFAULT_DEVICE,
    ):
        super().__init__()
        device = resolve(device)
        self.min_log_std, self.max_log_std = min_log_std, max_log_std
        self.shared_trunk = shared_trunk
        in_dim = proprio_dim
        self.pi_encoder = self.v_encoder = None
        if vision_shape is not None:
            h, w, c = vision_shape
            self.pi_encoder = VisionEncoder(c, device=device)
            if not shared_trunk:
                self.v_encoder = VisionEncoder(c, device=device)
            in_dim += VisionEncoder.out_features(h, w)

        def tower():
            layers, d = [], in_dim
            for hd in hidden:
                layers += [nn.Linear(d, hd, device=device), nn.ELU()]
                d = hd
            return nn.Sequential(*layers)

        self.pi_tower = tower()
        self.v_tower = None if shared_trunk else tower()
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
        if encoder is None:
            return obs["proprio_obs"]
        return torch.cat([encoder(obs["vision_obs"]), obs["proprio_obs"]], dim=-1)

    def forward(self, obs: dict[str, torch.Tensor]):
        pol = self.pi_tower(self._features(self.pi_encoder, obs))
        val = pol if self.shared_trunk else self.v_tower(self._features(self.v_encoder, obs))
        mean = self.mean_head(pol)
        log_std = torch.clamp(self.log_std, self.min_log_std, self.max_log_std).expand_as(mean)
        value = self.value_head(val)[..., 0]
        return mean, log_std, value


def gaussian_log_prob(mean: torch.Tensor, log_std: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    var = torch.exp(2 * log_std)
    lp = -0.5 * ((action - mean) ** 2 / var + 2 * log_std + math.log(2 * math.pi))
    return lp.sum(dim=-1)


def gaussian_entropy(log_std: torch.Tensor) -> torch.Tensor:
    return (log_std + 0.5 * math.log(2 * math.pi * math.e)).sum(dim=-1)


def _flax_layout(n_hidden: int, vision: bool, shared_trunk: bool) -> tuple[list, list]:
    """How the state_dict's names map onto the JAX network's: (dense, conv)
    lists of (state_dict prefix, flax path). Flax names the layers in call
    order: ``VisionEncoder_0`` and ``Dense_0..`` for the policy tower,
    ``VisionEncoder_1`` and the next Dense layers for the value tower (none
    with a shared trunk), then the mean head and the value head."""
    towers = ("pi",) if shared_trunk else ("pi", "v")
    dense = [(f"{t}_tower.{2 * i}", f"Dense_{k * n_hidden + i}") for k, t in enumerate(towers) for i in range(n_hidden)]
    d = len(towers) * n_hidden
    dense += [("mean_head", f"Dense_{d}"), ("value_head", f"Dense_{d + 1}")]
    conv = []
    if vision:
        conv = [
            (f"{t}_encoder.conv{i}", (f"VisionEncoder_{k}", f"Conv_{i}"))
            for k, t in enumerate(towers)
            for i in range(2)
        ]
    return dense, conv


def actor_critic_from_flax(params, shared_trunk: bool = False) -> dict[str, torch.Tensor]:
    """``ActorCritic`` state_dict from the JAX network's params (numpy
    leaves), with or without ``VisionEncoder_*``; ``shared_trunk`` as the
    JAX network was built (the tree alone does not tell a shared trunk of
    2h layers from separate towers of h). Conv kernels go from HWIO to OIHW;
    Dense kernels (in, out) are transposed."""
    p = params.get("params", params)
    t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32, copy=True))
    n_hidden = (sum(1 for k in p if k.startswith("Dense_")) - 2) // (1 if shared_trunk else 2)
    dense, conv = _flax_layout(n_hidden, "VisionEncoder_0" in p, shared_trunk)
    sd = {}
    for prefix, name in dense:
        sd[f"{prefix}.weight"] = t(p[name]["kernel"]).T.contiguous()
        sd[f"{prefix}.bias"] = t(p[name]["bias"])
    for prefix, (enc, name) in conv:
        sd[f"{prefix}.weight"] = t(p[enc][name]["kernel"]).permute(3, 2, 0, 1).contiguous()
        sd[f"{prefix}.bias"] = t(p[enc][name]["bias"])
    sd["log_std"] = t(p["log_std"])
    return sd


def actor_critic_to_flax(state_dict) -> dict:
    """The inverse of ``actor_critic_from_flax``: the JAX network's
    ``{"params": ...}`` tree, numpy leaves, from an ``ActorCritic`` state_dict."""
    a = lambda x: x.detach().cpu().numpy().copy()
    n_hidden = sum(1 for k in state_dict if k.startswith("pi_tower.") and k.endswith(".weight"))
    shared_trunk = not any(k.startswith("v_tower.") for k in state_dict)
    dense, conv = _flax_layout(n_hidden, "pi_encoder.conv0.weight" in state_dict, shared_trunk)
    p: dict = {"log_std": a(state_dict["log_std"])}
    for prefix, name in dense:
        p[name] = {"kernel": a(state_dict[f"{prefix}.weight"].T), "bias": a(state_dict[f"{prefix}.bias"])}
    for prefix, (enc, name) in conv:
        kernel = a(state_dict[f"{prefix}.weight"].permute(2, 3, 1, 0))
        p.setdefault(enc, {})[name] = {"kernel": kernel, "bias": a(state_dict[f"{prefix}.bias"])}
    return {"params": p}
