"""The paper's experiment models (Appendix III-C), ported from
``repro/models/vision.py``: small CNN (MNIST), ResNet-GN (CIFAR-10),
ResNet18-GN (CIFAR-100) and a ViT classifier.

``make_model(name, num_classes, image_size, channels, device)`` returns
``(init_fn(seed) -> params, apply_fn(params, images) -> logits)``.  Params
keep the JAX package's layout (HWIO convolution weights, (d_in, d_out) dense
weights) and images its NHWC layout; the convolutional models permute to
NCHW once at entry and HWIO to OIHW at each ``F.conv2d``.

Matching the reference:
  * ``padding="SAME"`` pads ``(k-1)//2`` before and the rest after, so a 3×3
    stride-2 convolution on an even size pads (0, 1), not (1, 1);
  * GroupNorm uses the biased variance with eps 1e-5;
  * max-pooling is "VALID" (floor);
  * ``jax.nn.gelu`` is the tanh approximation.
"""
from __future__ import annotations

import math
from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.models.layers import dense, dense_init, layernorm, layernorm_init


# ---------------------------------------------------------------------------
# primitives (activations NCHW inside the convolutional models)
# ---------------------------------------------------------------------------
def conv_init(gen, kh, kw, cin, cout, dtype=torch.float32):
    fan_in = kh * kw * cin
    w = torch.randn((kh, kw, cin, cout), generator=gen, device=gen.device)
    return {"w": (w * math.sqrt(2.0 / fan_in)).to(dtype),
            "b": torch.zeros((cout,), dtype=dtype, device=gen.device)}


def _same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv(p, x, stride=1):
    """SAME convolution of NCHW ``x`` with an HWIO weight."""
    kh, kw = p["w"].shape[:2]
    w = p["w"].permute(3, 2, 0, 1)
    (t, b), (l, r) = (_same_pads(x.shape[2], kh, stride),
                      _same_pads(x.shape[3], kw, stride))
    if t == b and l == r:
        return F.conv2d(x, w, p["b"], stride, (t, l))
    return F.conv2d(F.pad(x, (l, r, t, b)), w, p["b"], stride)


def groupnorm_init(c, device, dtype=torch.float32):
    return {"scale": torch.ones((c,), dtype=dtype, device=device),
            "bias": torch.zeros((c,), dtype=dtype, device=device)}


def groupnorm(p, x, groups, eps=1e-5):
    g = min(groups, x.shape[1])
    y = F.group_norm(x.to(torch.float32), g, p["scale"], p["bias"], eps)
    return y.to(x.dtype)


def maxpool(x, k=2, s=2):
    return F.max_pool2d(x, k, s)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# CNN (Table 9)
# ---------------------------------------------------------------------------
def cnn_init(gen, num_classes, image_size, channels):
    flat = (image_size // 4) ** 2 * 32
    dev = gen.device
    return {
        "conv1": conv_init(gen, 5, 5, channels, 16), "gn1": groupnorm_init(16, dev),
        "conv2": conv_init(gen, 5, 5, 16, 32), "gn2": groupnorm_init(32, dev),
        "fc1": dense_init(gen, flat, 128, torch.float32, bias=True),
        "fc2": dense_init(gen, 128, num_classes, torch.float32, bias=True),
    }


def cnn_apply(p, x):
    x = _nchw(x)
    x = maxpool(F.relu(groupnorm(p["gn1"], conv(p["conv1"], x), 4)))
    x = maxpool(F.relu(groupnorm(p["gn2"], conv(p["conv2"], x), 4)))
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)    # NHWC flatten order
    x = F.relu(dense(p["fc1"], x))
    return dense(p["fc2"], x)


# ---------------------------------------------------------------------------
# ResNet-GN (Tables 11 / 12)
# ---------------------------------------------------------------------------
def _basic_block_init(gen, cin, cout, stride):
    dev = gen.device
    p = {"conv1": conv_init(gen, 3, 3, cin, cout), "gn1": groupnorm_init(cout, dev),
         "conv2": conv_init(gen, 3, 3, cout, cout), "gn2": groupnorm_init(cout, dev)}
    if stride != 1 or cin != cout:
        p["proj"] = conv_init(gen, 1, 1, cin, cout)
    return p


def _basic_block_apply(p, x, stride, groups):
    h = F.relu(groupnorm(p["gn1"], conv(p["conv1"], x, stride), groups))
    h = groupnorm(p["gn2"], conv(p["conv2"], h), groups)
    sc = conv(p["proj"], x, stride) if "proj" in p else x
    return F.relu(h + sc)


def resnet_init(gen, num_classes, image_size, channels, *, stages, widths, groups):
    p = {"stem": conv_init(gen, 3, 3, channels, widths[0]),
         "gn0": groupnorm_init(widths[0], gen.device)}
    cin = widths[0]
    for s, (n, w) in enumerate(zip(stages, widths)):
        for b in range(n):
            stride = 2 if (b == 0 and s > 0) else 1
            p[f"s{s}b{b}"] = _basic_block_init(gen, cin, w, stride)
            cin = w
    p["fc"] = dense_init(gen, cin, num_classes, torch.float32, bias=True)
    return p


def resnet_apply(p, x, *, stages, widths, groups):
    x = F.relu(groupnorm(p["gn0"], conv(p["stem"], _nchw(x)), groups[0]))
    for s, (n, w) in enumerate(zip(stages, widths)):
        for b in range(n):
            stride = 2 if (b == 0 and s > 0) else 1
            x = _basic_block_apply(p[f"s{s}b{b}"], x, stride, groups[s])
    return dense(p["fc"], x.mean(dim=(2, 3)))


# ---------------------------------------------------------------------------
# ViT classifier (Table 10, reduced-scale by default)
# ---------------------------------------------------------------------------
def vit_init(gen, num_classes, image_size, channels, *, patch=4, d=192,
             depth=6, heads=3, mlp_ratio=4):
    dev = gen.device
    n_patches = (image_size // patch) ** 2
    f32 = torch.float32
    p = {
        "patch": dense_init(gen, patch * patch * channels, d, f32, bias=True),
        "pos": torch.randn((1, n_patches + 1, d), generator=gen, device=dev) * 0.02,
        "cls": torch.zeros((1, 1, d), device=dev),
        "head": dense_init(gen, d, num_classes, f32, bias=True),
        "ln_f": layernorm_init(d, f32, dev),
    }
    for i in range(depth):
        p[f"blk{i}"] = {
            "ln1": layernorm_init(d, f32, dev),
            "qkv": dense_init(gen, d, 3 * d, f32, bias=True),
            "proj": dense_init(gen, d, d, f32, bias=True),
            "ln2": layernorm_init(d, f32, dev),
            "fc1": dense_init(gen, d, mlp_ratio * d, f32, bias=True),
            "fc2": dense_init(gen, mlp_ratio * d, d, f32, bias=True),
        }
    return p


def vit_apply(p, x, *, patch=4, heads=3, depth=6):
    B, H, W, C = x.shape
    xp = x.reshape(B, H // patch, patch, W // patch, patch, C)
    xp = xp.permute(0, 1, 3, 2, 4, 5).reshape(B, -1, patch * patch * C)
    h = dense(p["patch"], xp)
    h = torch.cat([p["cls"].expand(B, 1, h.shape[-1]), h], dim=1)
    h = h + p["pos"]
    d = h.shape[-1]
    hd = d // heads
    for i in range(depth):
        blk = p[f"blk{i}"]
        hn = layernorm(blk["ln1"], h)
        qkv = dense(blk["qkv"], hn).reshape(B, -1, 3, heads, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        a = torch.softmax(s, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(B, -1, d)
        h = h + dense(blk["proj"], o)
        hn = layernorm(blk["ln2"], h)
        h = h + dense(blk["fc2"], F.gelu(dense(blk["fc1"], hn), approximate="tanh"))
    h = layernorm(p["ln_f"], h)
    return dense(p["head"], h[:, 0])


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
def make_model(name: str, num_classes: int, image_size: int, channels: int,
               device="cuda") -> Tuple[Callable, Callable]:
    dev = resolve_device(device)

    def seeded(init):
        return lambda seed: init(torch.Generator(device=dev).manual_seed(seed))

    if name == "cnn":
        return (seeded(lambda g: cnn_init(g, num_classes, image_size, channels)),
                cnn_apply)
    if name == "resnet":        # paper's 0.27M CIFAR-10 ResNet
        kw = dict(stages=(3, 3, 3), widths=(16, 32, 64), groups=(4, 8, 16))
    elif name == "resnet18":    # paper's 11M CIFAR-100 ResNet-18
        kw = dict(stages=(2, 2, 2, 2), widths=(64, 128, 256, 512),
                  groups=(32, 32, 32, 32))
    elif name == "vit":         # reduced-scale stand-in for ViT-B/16 + LoRA
        return (seeded(lambda g: vit_init(g, num_classes, image_size, channels,
                                          d=192, depth=6, heads=3)),
                lambda p, x: vit_apply(p, x, patch=4, heads=3, depth=6))
    else:
        raise ValueError(name)
    return (seeded(lambda g: resnet_init(g, num_classes, image_size, channels, **kw)),
            lambda p, x: resnet_apply(p, x, **kw))
