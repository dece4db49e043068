"""SiT (Ma et al., arXiv:2401.08740; github.com/willisma/SiT models.py) on
the DiT backbone (Peebles & Xie, arXiv:2212.09748), in plain float32
PyTorch: the published equations, written out.

* patches: a stride-p, padding-0 convolution of x [B, C, H, W] with p×p
  kernels, flattened to N = (H/p)·(W/p) tokens of `hidden_size`, plus the
  fixed 2-D sin-cos table (column embedding, then row embedding, each sin
  then cos over 1/10000^(i/(hidden/4)));
* c = MLP(cos-first 256-d embedding of t, frequencies
  exp(-ln(10^4)·i/128)) + E[y], E a (num_classes + 1)-row table; in train
  mode a label becomes the null class num_classes where
  `torch.rand(B) < class_dropout_prob`, from the device's default
  generator;
* each of `depth` blocks: (shift_a, scale_a, gate_a, shift_m, scale_m,
  gate_m) = Linear(SiLU(c)); x += gate_a·Attn(LN(x)(1 + scale_a) +
  shift_a); x += gate_m·MLP(LN(x)(1 + scale_m) + shift_m); LN without
  affine, eps 1e-6; Attn: qkv = Linear(x) split into `num_heads` heads,
  softmax(q kᵀ / sqrt(d)) v materialised, proj; MLP: fc2(GELU_tanh(fc1));
* final: (shift, scale) = Linear(SiLU(c)); Linear(LN(x)(1 + scale) +
  shift) to p·p·C_out a token, unpatchified (n h w p q c -> n c (h p)
  (w q)); with learn_sigma C_out = 2C and the first C channels are v.

`forward(o, arch, x, (t, y))`. Dense layers go through `o.dense`; the
patch convolution and the attention's two products read their inputs
through `o.r`, so a control's precision reaches every product. The state
dict leaves out SiT's `pos_embed` (a fixed table, not a weight)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FREQ_DIM = 256
LN_EPS = 1e-6


def _dense(pre, cin, cout):
    return [(f"{pre}.weight", (cout, cin)), (f"{pre}.bias", (cout,))]


def _dims(arch):
    h, p = arch["hidden_size"], arch["patch_size"]
    c_out = arch["in_channels"] * (2 if arch["learn_sigma"] else 1)
    n = (arch["input_size"] // p) ** 2
    return h, p, c_out, n, int(h * arch["mlp_ratio"])


def layout(arch):
    h, p, c_out, _, mlp = _dims(arch)
    cin = arch["in_channels"]
    drop_row = int(arch["class_dropout_prob"] > 0)
    lay = [("x_embedder.proj.weight", (h, cin, p, p)),
           ("x_embedder.proj.bias", (h,))]
    lay += _dense("t_embedder.mlp.0", FREQ_DIM, h)
    lay += _dense("t_embedder.mlp.2", h, h)
    lay += [("y_embedder.embedding_table.weight",
             (arch["num_classes"] + drop_row, h))]
    for i in range(arch["depth"]):
        b = f"blocks.{i}"
        lay += (_dense(f"{b}.attn.qkv", h, 3 * h)
                + _dense(f"{b}.attn.proj", h, h)
                + _dense(f"{b}.mlp.fc1", h, mlp)
                + _dense(f"{b}.mlp.fc2", mlp, h)
                + _dense(f"{b}.adaLN_modulation.1", h, 6 * h))
    return (lay + _dense("final_layer.linear", h, p * p * c_out)
            + _dense("final_layer.adaLN_modulation.1", h, 2 * h))


def pos_table(dim: int, grid: int) -> torch.Tensor:
    """[grid², dim] float32: SiT's get_2d_sincos_pos_embed (computed in
    float64, as SiT's numpy does, then rounded)."""
    g = torch.arange(grid, dtype=torch.float32).to(torch.float64)
    rows, cols = torch.meshgrid(g, g, indexing="ij")

    def one_d(d, pos):
        omega = 1.0 / 10000 ** (torch.arange(d // 2, dtype=torch.float64)
                                / (d / 2.0))
        out = pos.reshape(-1)[:, None] * omega[None, :]
        return torch.cat([torch.sin(out), torch.cos(out)], dim=1)

    return torch.cat([one_d(dim // 2, cols), one_d(dim // 2, rows)],
                     dim=1).to(torch.float32)


def _t_embedding(t):
    half = FREQ_DIM // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _ln(x):
    return F.layer_norm(x, x.shape[-1:], eps=LN_EPS)


def _mod(x, shift, scale):
    return x * (1 + scale[:, None]) + shift[:, None]


def _r(o, x):
    return x if o.r is None else o.r(x)


def _attention(o, pre, x, heads):
    B, N, C = x.shape
    d = C // heads
    qkv = o.dense(f"{pre}.qkv", x).reshape(B, N, 3, heads, d).permute(
        2, 0, 3, 1, 4)
    q, k, v = qkv[0] * (1.0 / math.sqrt(d)), qkv[1], qkv[2]
    w = torch.softmax(_r(o, q) @ _r(o, k).transpose(-2, -1), dim=-1)
    a = (_r(o, w) @ _r(o, v)).transpose(1, 2).reshape(B, N, C)
    return o.dense(f"{pre}.proj", a)


def forward(o, arch, x, b):
    t, y = b
    P = o.P
    h, p, c_out, n, _ = _dims(arch)
    B, grid = x.shape[0], arch["input_size"] // p
    w = P["x_embedder.proj.weight"]
    z = F.conv2d(_r(o, x), _r(o, w), P["x_embedder.proj.bias"], stride=p)
    z = z.flatten(2).transpose(1, 2) + pos_table(h, grid).to(x.device)
    temb = o.dense("t_embedder.mlp.2", F.silu(o.dense(
        "t_embedder.mlp.0", _t_embedding(t))))
    if o.train and arch["class_dropout_prob"] > 0:
        drop = torch.rand(B, device=y.device) < arch["class_dropout_prob"]
        y = torch.where(drop, arch["num_classes"], y)
    c = temb + P["y_embedder.embedding_table.weight"][y]
    sc = F.silu(c)
    for i in range(arch["depth"]):
        pre = f"blocks.{i}"
        sa, ka, ga, sm, km, gm = o.dense(f"{pre}.adaLN_modulation.1",
                                         sc).chunk(6, dim=1)
        z = z + ga[:, None] * _attention(o, f"{pre}.attn",
                                         _mod(_ln(z), sa, ka),
                                         arch["num_heads"])
        m = F.gelu(o.dense(f"{pre}.mlp.fc1", _mod(_ln(z), sm, km)),
                   approximate="tanh")
        z = z + gm[:, None] * o.dense(f"{pre}.mlp.fc2", m)
    shift, scale = o.dense("final_layer.adaLN_modulation.1",
                           sc).chunk(2, dim=1)
    z = o.dense("final_layer.linear", _mod(_ln(z), shift, scale))
    z = z.reshape(B, grid, grid, p, p, c_out)
    v = torch.einsum("nhwpqc->nchpwq", z).reshape(B, c_out, grid * p,
                                                   grid * p)
    return v[:, :arch["in_channels"]]


def attn_flops(arch, batch):
    """FLOPs of the attention's two products (q kᵀ and the weights times v)
    in one forward at `batch`: 2 × 2 × N² × hidden a block and example."""
    h, _, _, n, _ = _dims(arch)
    return float(batch * arch["depth"] * 2 * 2 * n * n * h)


def flops(arch, batch):
    """Forward FLOPs at `batch`: 2 × the MACs of the patch convolution, of
    every dense layer (the time MLP and the adaLN modulations once an
    example, the rest once a token) and `attn_flops`. The label table is
    a gather, not a product."""
    h, p, c_out, n, mlp = _dims(arch)
    macs = n * arch["in_channels"] * p * p * h
    macs += FREQ_DIM * h + h * h
    macs += arch["depth"] * (h * 6 * h + n * (h * 3 * h + h * h
                                              + 2 * h * mlp))
    macs += h * 2 * h + n * h * p * p * c_out
    return 2.0 * batch * macs + attn_flops(arch, batch)
