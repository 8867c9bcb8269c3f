"""Everything a run feeds the program, made from ``--seed`` by the
benchmark itself: the weights, the scenes (views and cameras), and the
request pool built on them.

All of it is drawn on the run's device by a ``torch.Generator`` in a few
large calls. The weights are a state dict with the reference
implementation's keys; the program and the reference get the same one.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.model import conv_layers

# Drawn weights: He-normal with fan-in for every convolution (the heads a
# quarter of that, so the sigmoids sit in their working range), and batch
# norms with parameters and running statistics near the identity.
HEAD_GAIN = 0.25
NORM_SPREAD = 0.1


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator on ``device`` for one use (``stream``) of ``seed``; any
    whole number is taken."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (2**63))
    return g


def make_state(planes: int, seed: int, device, conv_dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The seeded weights of the whole net, on ``device``: convolution
    weights in ``conv_dtype`` (the type they are served in), norms f32."""
    layers = conv_layers(planes)
    sizes = []
    for name, cin, cout, k, _, _, head in layers:
        sizes.append(cout * cin * k * k)
        sizes.append(cout if head else 4 * cout)
    z = torch.randn(sum(sizes), generator=generator(seed, device, 1), device=device)
    parts = iter(z.split(sizes))
    state = {}
    for name, cin, cout, k, _, _, head in layers:
        std = math.sqrt(2.0 / (cin * k * k)) * (HEAD_GAIN if head else 1.0)
        state[f"{name}.weight"] = (next(parts).view(cout, cin, k, k) * std).to(conv_dtype)
        extra = next(parts)
        if head:
            state[f"{name}.bias"] = (extra * NORM_SPREAD).to(conv_dtype)
            continue
        prefix, index = name.rsplit(".", 1)
        n = f"{prefix}.{int(index) + 1}"
        w, b, mean, var = extra.view(4, cout)
        state[f"{n}.weight"] = 1.0 + NORM_SPREAD * w
        state[f"{n}.bias"] = NORM_SPREAD * b
        state[f"{n}.running_mean"] = NORM_SPREAD * mean
        state[f"{n}.running_var"] = 1.0 + NORM_SPREAD * var.abs()
        state[f"{n}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64, device=device)
    return state


def _rotation(angles: torch.Tensor) -> torch.Tensor:
    """``[N, 3]`` small angles (radians) -> rotation matrices ``[N, 3, 3]``."""
    a, b, c = angles.double().unbind(-1)
    one, zero = torch.ones_like(a), torch.zeros_like(a)
    rx = torch.stack([one, zero, zero, zero, a.cos(), -a.sin(), zero, a.sin(), a.cos()], -1)
    ry = torch.stack([b.cos(), zero, b.sin(), zero, one, zero, -b.sin(), zero, b.cos()], -1)
    rz = torch.stack([c.cos(), -c.sin(), zero, c.sin(), c.cos(), zero, zero, zero, one], -1)
    return rx.view(-1, 3, 3) @ ry.view(-1, 3, 3) @ rz.view(-1, 3, 3)


def make_scenes(n: int, height: int, width: int, offsets, seed: int, device):
    """``n`` scenes of ``1 + len(offsets)`` views: [0, 1] RGB ``[n, V, H, W,
    3]`` f32 and cameras ``[n, V, 2, 4, 4]`` f32. The reference camera sits
    at the origin; a source ``o`` frames away has moved about ``0.01 |o|`` m
    and turned about ``0.1 |o|`` degrees, as a hand-held camera at 30
    frames/s does. Each view is a smooth texture with fine grain."""
    V = 1 + len(offsets)
    g = generator(seed, device, 2)
    coarse = torch.rand(n * V, 3, max(height // 16, 2), max(width // 16, 2), generator=g,
                        device=device)
    fine = torch.rand(n * V, 3, height, width, generator=g, device=device)
    smooth = F.interpolate(coarse, size=(height, width), mode="bicubic", align_corners=False)
    rgb = (0.8 * smooth + 0.2 * fine).clamp(0, 1).permute(0, 2, 3, 1).reshape(n, V, height, width, 3)
    f = 0.8 * width
    K = torch.tensor([[f, 0.0, width / 2.0], [0.0, f, height / 2.0], [0.0, 0.0, 1.0]],
                     dtype=torch.float64, device=device)
    scale = torch.tensor([0.0] + [abs(o) / 10.0 for o in offsets], dtype=torch.float64,
                         device=device)
    moves = torch.randn(n, V, 6, generator=g, device=device).double()
    t = moves[..., :3] * 0.06 * scale[None, :, None]
    R = _rotation((moves[..., 3:] * math.radians(0.6) * scale[None, :, None]).reshape(-1, 3))
    cams = torch.zeros(n, V, 2, 4, 4, dtype=torch.float64, device=device)
    cams[:, :, 0, :3, :3] = R.view(n, V, 3, 3)
    cams[:, :, 0, :3, 3] = t
    cams[:, :, 0, 3, 3] = 1.0
    cams[:, :, 1, :3, :3] = K
    cams[:, :, 1, 3, 3] = 1.0
    return rgb, cams.float()


def request_pool(n: int, bases: int, height: int, width: int, offsets, seed: int, device,
                 chunk: int = 256):
    """``n`` distinct single-frame requests over ``bases`` scenes: uint8
    views ``[n, V, H, W, 3]`` (the scene plus the request's own noise in [-3,
    3]) and cameras ``[n, V, 2, 4, 4]``, as host numpy arrays, made ``chunk``
    requests at a time so that the device holds little of them."""
    rgb, cams = make_scenes(bases, height, width, offsets, seed, device)
    base = torch.round(rgb * 255.0).to(torch.int16)
    which = torch.arange(n, device=device) % bases
    g = generator(seed, device, 3)
    images = np.empty((n,) + tuple(base.shape[1:]), np.uint8)
    for i in range(0, n, chunk):
        m = min(chunk, n - i)
        noise = torch.randint(-3, 4, (m,) + base.shape[1:], generator=g, device=device,
                              dtype=torch.int16)
        images[i:i + m] = (base[which[i:i + m]] + noise).clamp(0, 255).to(torch.uint8).cpu().numpy()
    return images, cams[which].cpu().numpy()

