"""DroidNet, plain: the encoders and the update operator in fp32 (or in
the control's fp8), from the checkpoint file.

Written against the flax parameter tree of ``droid_synthetic.ckpt``
(HWIO kernels): fnet/cnet = 7x7/2 stem, residual stages of 32/64/128
channels to 1/8 resolution, a 1x1 head (fnet instance-normalized, cnet
not); the update operator = corr encoder (196 -> 128 -> 128), flow
encoder (4 -> 128 -> 64), a ConvGRU with global-context gates, delta and
weight heads; GraphAgg = an edge-side 3x3 conv, a mean over each source
frame's edges and a frame head giving the damping eta.

``Net(params, precision)``: precision "fp32" computes every convolution
in fp32 (TF32 off); "fp8" is the control: the operands of the
convolutions the configuration runs in bf16 are rounded to float8 e4m3
with one scale per tensor (amax to 448) before an fp32 convolution; the
fp32 parts (normalization statistics, the GRU mean, the frame head) stay
fp32.
"""
from __future__ import annotations

import pickle

import numpy as np
import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
CORR_CHANNELS = 196


def load_params(path: str, device) -> dict:
    """{'<module>/<conv>': (weight OIHW, bias)} of the checkpoint."""
    with open(path, "rb") as f:
        tree = pickle.load(f)["params"]
    out = {}

    def walk(node, prefix):
        if "kernel" in node:
            k = np.asarray(node["kernel"], np.float32)
            w = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
            b = torch.from_numpy(np.asarray(node["bias"], np.float32).copy())
            out[prefix] = (w.to(device), b.to(device))
            return
        for k, v in node.items():
            walk(v, f"{prefix}/{k}" if prefix else k)

    walk(tree, "")
    return out


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the whole tensor."""
    amax = x.detach().abs().amax().float().clamp(min=1e-12)
    s = E4M3_MAX / amax
    return ((x.float() * s).to(torch.float8_e4m3fn).float() / s)


class Net:
    def __init__(self, params: dict, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(precision)
        self.p = params
        self.fp8 = precision == "fp8"

    # -- primitives (NCHW) ------------------------------------------------
    def conv(self, name, x, stride=1, low=True):
        w, b = self.p[name]
        pad = w.shape[-1] // 2
        x = x.float()
        if self.fp8 and low:
            x, w = fp8_round(x), fp8_round(w)
        return F.conv2d(x, w, b, stride, pad)

    @staticmethod
    def inorm(x, eps=1e-5):
        m = x.mean(dim=(-2, -1), keepdim=True)
        v = x.var(dim=(-2, -1), keepdim=True, unbiased=False)
        return (x - m) * torch.rsqrt(v + eps)

    # -- encoders ---------------------------------------------------------
    def encoder(self, enc: str, images: torch.Tensor) -> torch.Tensor:
        """images [B, H, W, 3] in [0, 1] -> [B, H/8, W/8, C] fp32."""
        mean = images.new_tensor((0.485, 0.456, 0.406))
        std = images.new_tensor((0.229, 0.224, 0.225))
        x = ((images - mean) / std).permute(0, 3, 1, 2)
        norm = self.inorm if enc == "fnet" else (lambda h: h)
        x = F.relu(norm(self.conv(f"{enc}/conv1", x, 2)))
        for stage, stride in ((1, 1), (2, 2), (3, 2)):
            for blk in (0, 1):
                name = f"{enc}/layer{stage}_{blk}"
                s = stride if blk == 0 else 1
                y = F.relu(norm(self.conv(f"{name}/conv1", x, s)))
                y = F.relu(norm(self.conv(f"{name}/conv2", y)))
                if f"{name}/downsample" in self.p:
                    x = norm(self.conv(f"{name}/downsample", x, s))
                x = F.relu(x + y)
        return self.conv(f"{enc}/conv2", x).permute(0, 2, 3, 1)

    def context(self, images):
        """-> (tanh(net), relu(inp)), each [B, h, w, 128]."""
        c = self.encoder("cnet", images)
        return torch.tanh(c[..., :128]), F.relu(c[..., 128:])

    # -- update operator --------------------------------------------------
    def update(self, net, inp, corr, flow):
        """All NHWC [E, h, w, .]: -> (net, delta, weight before the
        calibration)."""
        u = "update"
        net, inp = net.float().permute(0, 3, 1, 2), inp.float().permute(
            0, 3, 1, 2)
        c = F.relu(self.conv(f"{u}/corr_enc1", corr.permute(0, 3, 1, 2)))
        c = F.relu(self.conv(f"{u}/corr_enc2", c))
        f = F.relu(self.conv(f"{u}/flow_enc1", flow.permute(0, 3, 1, 2)))
        f = F.relu(self.conv(f"{u}/flow_enc2", f))
        x = torch.cat([inp, c, f], dim=1)
        g = f"{u}/gru"
        hx = torch.cat([net, x], dim=1)
        glo = torch.sigmoid(self.conv(f"{g}/w", net)) * net
        glo = glo.mean(dim=(-2, -1), keepdim=True)
        z = torch.sigmoid(self.conv(f"{g}/convz", hx)
                          + self.conv(f"{g}/convz_glo", glo))
        r = torch.sigmoid(self.conv(f"{g}/convr", hx)
                          + self.conv(f"{g}/convr_glo", glo))
        q = torch.tanh(self.conv(f"{g}/convq", torch.cat([r * net, x], 1))
                       + self.conv(f"{g}/convq_glo", glo))
        net = (1 - z) * net + z * q
        delta = self.conv(f"{u}/delta2", F.relu(self.conv(f"{u}/delta1",
                                                          net)))
        weight = torch.sigmoid(self.conv(
            f"{u}/weight2", F.relu(self.conv(f"{u}/weight1", net))))
        nhwc = (lambda t: t.permute(0, 2, 3, 1))
        return nhwc(net), nhwc(delta), nhwc(weight)

    def edge_features(self, net):
        """GraphAgg's edge side: [E, h, w, 128] -> [E, h, w, 128]."""
        return F.relu(self.conv("update/agg/conv1",
                                net.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)

    def frame_head(self, mean):
        """GraphAgg's frame side over the segment mean, always fp32:
        -> eta [P, h, w]."""
        a = F.relu(self.conv("update/agg/conv2", mean.permute(0, 3, 1, 2),
                             low=False))
        eta = F.softplus(self.conv("update/agg/eta", a, low=False))
        return 0.01 * eta[:, 0]
