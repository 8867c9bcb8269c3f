"""The frozen yardstick of work: operations and bytes computed from shapes,
and the card's published peaks. Nothing here looks at what the program
runs, so a change that drops or adds work cannot move it.

* Convolutions: 2 operations per multiply-add over the net's layer table
  (``reference/model.conv_layers``); a training step is the forward, the
  input gradient and the weight gradient of each, less the input gradient
  of the first convolution (its input, the image and the cost volume,
  takes none). Normalisation, activations, upsampling, losses and the
  optimiser are not counted.
* The two hand kernels (``kernel_cost``): each input read once and each
  output written once. The cost volume's 55 f32 operations a cost (pair,
  plane, pixel): X, Y, Z 6; z + eps 1; two divisions 2; floors 2; fractions
  2; 1 - f 2; four weights 4; 12 tap products and 12 accumulations 24;
  three differences, absolute values and two adds 8; the coordinate clip 4.
  Depth -> normal: backprojection 18, monomials 6, two separable k-tap
  passes over 9 sums 18 (k - 1), the adjugate solve and normalisation 62.
* Peaks of one H100 SXM (NVIDIA's data sheet, dense): 989 TFLOP/s bf16,
  495 TF32, 67 f32 outside the tensor cores, 3.35 TB/s HBM.
"""

from __future__ import annotations

from benchmark.reference.model import conv_layers

PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
CV_FLOPS = 55
CV_COEFS = 12  # f32 homography coefficients per pair


def _conv_flops(layer, height: int, width: int) -> int:
    _, cin, cout, k, _, level, _ = layer
    return 2 * cin * cout * k * k * (height // level) * (width // level)


def net_flops(model: dict, height: int, width: int, views: int, frames: int = 1) -> int:
    """Convolution operations of the forward of ``frames`` frames of
    ``views`` views: DepthNet on each of the ``views - 1`` pairs, the
    RefineNet once a frame."""
    layers = conv_layers(int(model["num_planes"]))
    depth = sum(_conv_flops(l, height, width) for l in layers if l[0].startswith("depth_net"))
    refine = sum(_conv_flops(l, height, width) for l in layers if l[0].startswith("refine_net"))
    return frames * ((views - 1) * depth + refine)


def normals_flops(k: int) -> int:
    return 18 + 6 + 18 * (k - 1) + 62


def kernel_cost(name: str, shape, out_bytes: int = 4):
    """``(flops, bytes)`` of one call. ``cost_volume``: shape ``(pairs, H, W,
    planes)`` (f32 reference and source, the pairs' coefficients, the plane
    table, the volume in ``out_bytes`` per cost); ``depth_to_normal``: ``(B,
    H, W, k)`` (f32 depth, ``K^-1``, f32 normals)."""
    if name == "cost_volume":
        pairs, H, W, P = shape
        costs = pairs * P * H * W
        return (costs * CV_FLOPS,
                2 * pairs * H * W * 3 * 4 + pairs * CV_COEFS * 4 + P * 4 + costs * out_bytes)
    if name == "depth_to_normal":
        B, H, W, k = shape
        return B * H * W * normals_flops(k), B * H * W * 4 + B * 9 * 4 + B * H * W * 3 * 4
    raise KeyError(name)


def least_seconds(name: str, shape, out_bytes: int = 4) -> float:
    """The least time one call can take on the card: the larger of its
    operations at the f32 peak and its bytes at the HBM peak."""
    flops, nbytes = kernel_cost(name, shape, out_bytes)
    return max(flops / PEAK_FLOPS["float32"], nbytes / PEAK_BYTES)


def forward_flops(model: dict, height: int, width: int, views: int, frames: int = 1,
                  normals: bool = True) -> int:
    """The refined forward of ``frames`` frames with its kernels: the
    convolutions, one cost volume over the pairs and, with ``normals``, one
    depth -> normal."""
    pairs = frames * (views - 1)
    P, k = int(model["num_planes"]), int(model["k_size"])
    return (net_flops(model, height, width, views, frames)
            + kernel_cost("cost_volume", (pairs, height, width, P))[0]
            + normals * kernel_cost("depth_to_normal", (frames, height, width, k))[0])


def train_step_flops(model: dict, height: int, width: int, views: int, batch: int) -> int:
    """One training step of ``batch`` samples: forward and both gradients of
    every convolution but the first's input gradient, one cost volume and
    three depth -> normals (predicted, refined and ground-truth depth)."""
    first = next(l for l in conv_layers(int(model["num_planes"])) if l[0].startswith("depth_net"))
    convs = 3 * net_flops(model, height, width, views, batch) \
        - (views - 1) * batch * _conv_flops(first, height, width)
    P, k = int(model["num_planes"]), int(model["k_size"])
    return (convs + kernel_cost("cost_volume", (batch * (views - 1), height, width, P))[0]
            + 3 * kernel_cost("depth_to_normal", (batch, height, width, k))[0])
