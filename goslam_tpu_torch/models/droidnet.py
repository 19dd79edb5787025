"""DroidNet: feature/context encoders and the recurrent update operator.

PyTorch modules in DROID's own layout (module names and OIHW weights as
in a ``droid.pth`` state dict), computed NCHW inside; every public
function takes and returns NHWC tensors, the layout of the rest of the
port.

  * fnet = BasicEncoder(128, instance norm), cnet = BasicEncoder(256, no
    norm): 7x7/2 stem + residual stages of 32/64/128 channels -> 1/8 res.
  * ConvGRU with global-context gates: a sigmoid-gated spatial mean of
    the hidden state (taken in fp32) enters z/r/q through 1x1 convs.
  * UpdateModule: corr (196 ch) and flow (4 ch) encoders, ConvGRU, delta
    and weight heads.
  * GraphAgg: split into ``edge_features`` (per edge) and ``frame_head``
    (per frame, always fp32) around a segment mean over the source frame.

Compute dtype: every conv of a module runs in its ``dtype`` (fp32 or
bf16; parameters stay fp32).  Instance-norm statistics, the GRU global
mean and GraphAgg's frame head are fp32 whatever the dtype.  On CPU a
bf16 conv is computed as an fp32 conv of bf16-rounded operands, rounded
to bf16 (CPU bf16 conv kernels are an order of magnitude slower; the
result is what a bf16 conv with fp32 accumulation gives).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

CORR_CHANNELS = 196


def conv(layer: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Apply a conv layer in the compute dtype (NCHW)."""
    w, b = layer.weight.to(dtype), layer.bias.to(dtype)
    if dtype == torch.bfloat16 and x.device.type == "cpu":
        y = F.conv2d(x.to(dtype).float(), w.float(), b.float(), layer.stride,
                     layer.padding)
        return y.to(dtype)
    return F.conv2d(x.to(dtype), w, b, layer.stride, layer.padding)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-sample, per-channel normalization over H, W (NCHW), no affine;
    statistics in fp32, result in x's dtype."""
    x32 = x.float()
    mean = x32.mean(dim=(-2, -1), keepdim=True)
    var = x32.var(dim=(-2, -1), keepdim=True, unbiased=False)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class ResidualBlock(nn.Module):
    def __init__(self, in_planes, planes, norm_fn="instance", stride=1):
        super().__init__()
        self.norm = norm_fn == "instance"
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, 1)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1)
        self.downsample = (nn.Sequential(nn.Conv2d(in_planes, planes, 1,
                                                   stride))
                           if stride > 1 else None)

    def forward(self, x, dtype):
        n = instance_norm if self.norm else (lambda h: h)
        y = F.relu(n(conv(self.conv1, x, dtype)))
        y = F.relu(n(conv(self.conv2, y, dtype)))
        if self.downsample is not None:
            x = n(conv(self.downsample[0], x, dtype))
        return F.relu(x.to(y.dtype) + y)


class BasicEncoder(nn.Module):
    """1/8-resolution encoder."""

    def __init__(self, out_dim, norm_fn="instance"):
        super().__init__()
        self.norm = norm_fn == "instance"
        self.conv1 = nn.Conv2d(3, 32, 7, 2, 3)
        self.layer1 = nn.Sequential(ResidualBlock(32, 32, norm_fn, 1),
                                    ResidualBlock(32, 32, norm_fn, 1))
        self.layer2 = nn.Sequential(ResidualBlock(32, 64, norm_fn, 2),
                                    ResidualBlock(64, 64, norm_fn, 1))
        self.layer3 = nn.Sequential(ResidualBlock(64, 128, norm_fn, 2),
                                    ResidualBlock(128, 128, norm_fn, 1))
        self.conv2 = nn.Conv2d(128, out_dim, 1)

    def forward(self, x, dtype=torch.float32):
        """x [B, H, W, 3] -> [B, H/8, W/8, out_dim] in dtype."""
        x = _nchw(x)
        y = conv(self.conv1, x, dtype)
        x = F.relu(instance_norm(y) if self.norm else y)
        for layer in (self.layer1, self.layer2, self.layer3):
            for block in layer:
                x = block(x, dtype)
        return _nhwc(conv(self.conv2, x, dtype))


class ConvGRU(nn.Module):
    def __init__(self, hidden=128, input_dim=128 + 128 + 64 + 128):
        super().__init__()
        self.convz = nn.Conv2d(hidden + input_dim, hidden, 3, padding=1)
        self.convr = nn.Conv2d(hidden + input_dim, hidden, 3, padding=1)
        self.convq = nn.Conv2d(hidden + input_dim, hidden, 3, padding=1)
        self.w = nn.Conv2d(hidden, hidden, 1)
        self.convz_glo = nn.Conv2d(hidden, hidden, 1)
        self.convr_glo = nn.Conv2d(hidden, hidden, 1)
        self.convq_glo = nn.Conv2d(hidden, hidden, 1)

    def forward(self, net, inp, dtype):
        """net [B,128,H,W], inp [B,Ci,H,W] (NCHW, in dtype)."""
        net_inp = torch.cat([net, inp], dim=1)
        glo = torch.sigmoid(conv(self.w, net, dtype)) * net
        # global-context mean in fp32
        glo = glo.float().mean(dim=(-2, -1), keepdim=True).to(glo.dtype)
        z = torch.sigmoid(conv(self.convz, net_inp, dtype)
                          + conv(self.convz_glo, glo, dtype))
        r = torch.sigmoid(conv(self.convr, net_inp, dtype)
                          + conv(self.convr_glo, glo, dtype))
        q = torch.tanh(conv(self.convq, torch.cat([r * net, inp], dim=1),
                            dtype) + conv(self.convq_glo, glo, dtype))
        return (1 - z) * net + z * q


class GraphAgg(nn.Module):
    """Frame-wise aggregation of edge hidden states -> damping eta (and
    the convex-upsampling mask)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(128, 128, 3, padding=1)
        self.conv2 = nn.Conv2d(128, 128, 3, padding=1)
        self.eta = nn.Sequential(nn.Conv2d(128, 1, 3, padding=1))
        self.upmask = nn.Sequential(nn.Conv2d(128, 8 * 8 * 9, 1))

    def edge_features(self, net: torch.Tensor, dtype) -> torch.Tensor:
        """Edge-side half: [E,H,W,128] -> [E,H,W,128] in dtype."""
        return _nhwc(F.relu(conv(self.conv1, _nchw(net), dtype)))

    def frame_head(self, agg: torch.Tensor, want_upmask: bool = True):
        """Frame-side half over the segment mean [P,H,W,128], in fp32.
        Returns (eta [P,H,W], upmask [P,H,W,576] or None)."""
        f32 = torch.float32
        agg = F.relu(conv(self.conv2, _nchw(agg.float()), f32))
        eta = F.softplus(conv(self.eta[0], agg, f32))
        upmask = _nhwc(conv(self.upmask[0], agg, f32)) if want_upmask \
            else None
        return 0.01 * eta[:, 0], upmask

    def forward(self, net, ii, edge_valid, num_frames: int, dtype):
        """net [E,H,W,128]; ii [E] source frames in [0, num_frames);
        edge_valid [E] bool.  Returns (eta [P,H,W], upmask, has_edge [P]).
        The segment sum runs in the dtype of the edge features."""
        net = self.edge_features(net, dtype)
        w = edge_valid.to(net.dtype)
        P = num_frames
        seg_sum = torch.zeros((P,) + net.shape[1:], dtype=net.dtype,
                              device=net.device).index_add_(
            0, ii, net * w[:, None, None, None])
        seg_cnt = torch.zeros(P, dtype=net.dtype,
                              device=net.device).index_add_(0, ii, w)
        agg = seg_sum / seg_cnt.clamp(min=1.0)[:, None, None, None]
        eta, upmask = self.frame_head(agg)
        return eta, upmask, seg_cnt > 0


class UpdateModule(nn.Module):
    """Recurrent flow/confidence update operator."""

    def __init__(self):
        super().__init__()
        self.corr_encoder = nn.Sequential(
            nn.Conv2d(CORR_CHANNELS, 128, 1), nn.ReLU(),
            nn.Conv2d(128, 128, 3, padding=1), nn.ReLU())
        self.flow_encoder = nn.Sequential(
            nn.Conv2d(4, 128, 7, padding=3), nn.ReLU(),
            nn.Conv2d(128, 64, 3, padding=1), nn.ReLU())
        self.weight = nn.Sequential(
            nn.Conv2d(128, 128, 3, padding=1), nn.ReLU(),
            nn.Conv2d(128, 2, 3, padding=1))
        self.delta = nn.Sequential(
            nn.Conv2d(128, 128, 3, padding=1), nn.ReLU(),
            nn.Conv2d(128, 2, 3, padding=1))
        self.gru = ConvGRU(128, 128 + 128 + 64)
        self.agg = GraphAgg()

    def forward(self, net, inp, corr, flow=None, dtype=torch.float32,
                ii=None, edge_valid=None, num_frames: int = 0):
        """All NHWC, batched over edges E: net [E,H,W,128] hidden,
        inp [E,H,W,128] context, corr [E,H,W,196], flow [E,H,W,4].

        Returns (net, delta [E,H,W,2], weight [E,H,W,2]) and, when ii is
        given, also (eta [P,H,W], upmask, has_edge [P]).  Mixed dtypes
        promote as in the flax modules: fp32 hidden state stays fp32."""
        if flow is None:
            flow = torch.zeros(net.shape[:-1] + (4,), dtype=dtype,
                               device=net.device)
        net, inp = _nchw(net), _nchw(inp)
        c = F.relu(conv(self.corr_encoder[0], _nchw(corr), dtype))
        c = F.relu(conv(self.corr_encoder[2], c, dtype))
        f = F.relu(conv(self.flow_encoder[0], _nchw(flow), dtype))
        f = F.relu(conv(self.flow_encoder[2], f, dtype))

        net = self.gru(net, torch.cat([inp, c, f], dim=1), dtype)
        delta = conv(self.delta[2], F.relu(conv(self.delta[0], net, dtype)),
                     dtype)
        weight = torch.sigmoid(conv(
            self.weight[2], F.relu(conv(self.weight[0], net, dtype)), dtype))
        net, delta, weight = _nhwc(net), _nhwc(delta), _nhwc(weight)
        if ii is None:
            return net, delta, weight
        eta, upmask, has_edge = self.agg(net, ii, edge_valid, num_frames,
                                         dtype)
        return net, delta, weight, eta, upmask, has_edge


class DroidNet(nn.Module):
    """fnet (matching features), cnet (context), update operator, and the
    confidence calibration ``weight_calib`` that scales the update's BA
    weights (1.0 = the net's raw sigmoid output)."""

    def __init__(self):
        super().__init__()
        self.fnet = BasicEncoder(128, "instance")
        self.cnet = BasicEncoder(256, "none")
        self.update = UpdateModule()
        self.register_buffer("weight_calib", torch.ones(()))

    def encode_context(self, images, dtype):
        """images [B,H,W,3] -> (tanh(net), relu(inp)), each [B,h,w,128]."""
        ctx = self.cnet(images, dtype)
        net, inp = ctx.split(128, dim=-1)
        return torch.tanh(net), F.relu(inp)


def init_droidnet(seed: int = 0, device=None) -> DroidNet:
    """Randomly initialized DroidNet (uniform fan-in init from an explicit
    generator seeded with `seed`)."""
    g = torch.Generator().manual_seed(seed)
    net = DroidNet()
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, nn.Conv2d):
                bound = 1.0 / (m.weight[0].numel() ** 0.5)
                m.weight.copy_(torch.rand(m.weight.shape, generator=g)
                               * 2 * bound - bound)
                m.bias.copy_(torch.rand(m.bias.shape, generator=g)
                             * 2 * bound - bound)
    return net.to(device)


# ---------------------------------------------------------------------------
# convex upsampling
# ---------------------------------------------------------------------------

def cvx_upsample(data: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """8x convex-combination upsampling of 1/8-res fields.

    data [B, ht, wd, C]; mask [B, ht, wd, 8*8*9] (logits over the 3x3
    neighbourhood per output subpixel, layout [9, 8, 8]).
    Returns [B, 8*ht, 8*wd, C]."""
    B, ht, wd, C = data.shape
    m = torch.softmax(mask.reshape(B, ht, wd, 9, 8, 8), dim=3)
    pad = F.pad(data, (0, 0, 1, 1, 1, 1))
    neigh = torch.stack([pad[:, dy:dy + ht, dx:dx + wd]
                         for dy in range(3) for dx in range(3)], dim=3)
    up = torch.einsum("bhwkyx,bhwkc->bhwyxc", m, neigh)
    return up.permute(0, 1, 3, 2, 4, 5).reshape(B, 8 * ht, 8 * wd, C)


def upsample_disp(disp: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """disp [B, ht, wd] -> [B, 8ht, 8wd]."""
    return cvx_upsample(disp[..., None], mask)[..., 0]
