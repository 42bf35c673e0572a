"""NeRF's MLP in plain PyTorch, float32, for the `nerf` configuration: the
layers and shapes it states and the forward pass over encoded points.

It imports nothing of the program.  The weights are the harness's own,
keyed by layer name, shaped (fan_in, fan_out); the reference reads them in
float32.
"""
from __future__ import annotations

import torch

from . import lowp


def layer_shapes(config: dict) -> dict[str, tuple[int, int]]:
    """{layer: (fan_in, fan_out)} in the order the forward applies them:
    `depth` layers of `width` (the input concatenated back after
    `skip_after` of them), the sigma head, the feature layer, the view
    layer on the feature and the view encoding, and the rgb head."""
    w, pw, vw = config["width"], config["pos_width"], config["view_width"]
    shapes = {}
    for i in range(config["depth"]):
        fan_in = pw if i == 0 else w + pw if i == config["skip_after"] else w
        shapes[f"fc{i}"] = (fan_in, w)
    shapes["sigma"] = (w, config["sigma_out"])
    shapes["feat"] = (w, config["feature_width"])
    shapes["rgb_fc"] = (config["feature_width"] + vw, config["view_hidden"])
    shapes["rgb"] = (config["view_hidden"], config["rgb_out"])
    return shapes


def forward(config: dict, weights: dict, pts: torch.Tensor, view: torch.Tensor,
            matmul=None) -> dict[str, torch.Tensor]:
    """{"out_rgb": (M, 3), "out_sigma": (M, 1)} in float32.  `matmul(x, w)`
    computes each layer's product (float32 by default; the control passes
    a lower precision's)."""
    mm = matmul or (lambda x, w: x @ w)
    pts, view = pts.float(), view.float()

    def lin(name, x):
        return mm(x, weights[name].float())

    h = pts
    for i in range(config["depth"]):
        if i == config["skip_after"]:
            h = torch.cat([h, pts], dim=-1)
        h = torch.relu(lin(f"fc{i}", h))
    sigma = lin("sigma", h)
    feat = lin("feat", h)
    h = torch.relu(lin("rgb_fc", torch.cat([feat, view], dim=-1)))
    return {"out_rgb": lin("rgb", h), "out_sigma": sigma}


def flops(config: dict, points: int) -> float:
    """Operations of one forward: 2 x M x fan_in x fan_out over its layers."""
    return float(sum(2 * points * k * n for k, n in layer_shapes(config).values()))


def forward_blocks(config: dict, weights: dict, pts, view, rows: int = 65536,
                   precision: str = "float32") -> dict[str, torch.Tensor]:
    """`forward` over blocks of `rows` points, so that the float32
    activations of a whole batch never exist at once; `precision`
    "float8_e4m3fn" is the control's."""
    mm = lowp.fp8_matmul if precision == "float8_e4m3fn" else None
    parts = [forward(config, weights, pts[i:i + rows], view[i:i + rows], mm)
             for i in range(0, pts.shape[0], rows)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
