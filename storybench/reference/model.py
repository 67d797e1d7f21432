"""The plain reference of the RCDMs story model: every tower in float32
PyTorch, with no kernel, no cache, no batching trick and no sharding.

It follows the published architecture (RCDMs, arXiv 2407.02482: SD-1.5's
UNet inflated over the story's frames with temporal modules, a
Kandinsky-2.2-style UnCLIP prior with temporal modules, CLIP bigG text and
vision towers, SD-1.5's text tower and VAE, and the seen / unseen fusion
stacks) and keeps the parameter names of the measured port, so that one
state dict of seeded weights feeds both. Images and feature maps are
channels-last: (..., h, w, c).

It imports nothing of the port and nothing of the JAX package: only torch.
Each module is built from a plain dict of sizes, the configuration file's.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def attention(q, k, v, heads: int, mask=None):
    """Softmax attention over token-major projections (..., S, heads * dh),
    scale dh ** -0.5, an additive mask broadcast over (..., heads, Sq,
    Skv)."""
    dh = q.shape[-1] // heads

    def split(t):
        return t.reshape(t.shape[:-1] + (heads, dh)).transpose(-3, -2)

    s = torch.matmul(split(q), split(k).transpose(-1, -2)) * dh ** -0.5
    if mask is not None:
        s = s + mask
    o = torch.matmul(torch.softmax(s, dim=-1), split(v))
    return o.transpose(-3, -2).reshape(q.shape[:-1] + (heads * dh,))


def frame_attention(q, k, v, heads: int):
    """Attention across the frame axis f of (b, f, n, c) at every token."""
    b, f, n, c = q.shape

    def split(t):  # (b, n, heads, f, dh)
        return t.reshape(b, f, n, heads, c // heads).permute(0, 2, 3, 1, 4)

    s = torch.matmul(split(q), split(k).transpose(-1, -2))
    p = torch.softmax(s * (c // heads) ** -0.5, dim=-1)
    return torch.matmul(p, split(v)).permute(0, 3, 1, 2, 4).reshape(q.shape)


def timestep_sinusoid(t, dim: int):
    """diffusers' timestep embedding as SD sets it: cos first, no shift."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def frame_positions(frames: int, dim: int, device):
    """The temporal modules' sinusoidal position code, (frames, dim)."""
    pos = torch.arange(frames, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32,
                                 device=device) * (-math.log(10000.0) / dim))
    pe = torch.zeros(frames, dim, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


class Conv(nn.Conv2d):
    """A 2-D conv over channels-last maps; leading axes fold into the
    batch."""

    def forward(self, x):
        lead = x.shape[:-3]
        y = super().forward(x.reshape((-1,) + x.shape[-3:])
                            .permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return y.reshape(lead + y.shape[1:])


class GroupNorm(nn.GroupNorm):
    """GroupNorm over channels-last maps, statistics per leading index."""

    def __init__(self, groups: int, channels: int, eps: float):
        super().__init__(groups, channels, eps)

    def forward(self, x):
        lead = x.shape[:-3]
        y = super().forward(x.reshape((-1,) + x.shape[-3:])
                            .permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return y.reshape(lead + y.shape[1:])


class TimeMLP(nn.Module):
    def __init__(self, d_in: int, d_hidden: int, d_out: int | None = None):
        super().__init__()
        self.linear_1 = nn.Linear(d_in, d_hidden)
        self.linear_2 = nn.Linear(d_hidden, d_out or d_hidden)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class Proj(nn.Module):
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.proj = nn.Linear(d_in, d_out)


class FeedForward(nn.Module):
    """GEGLU (h * gelu(gate)) or GELU feed-forward, width 4 * dim."""

    def __init__(self, dim: int, activation: str):
        super().__init__()
        self.geglu = activation == "geglu"
        inner = 4 * dim
        self.net = nn.ModuleList([Proj(dim, 2 * inner if self.geglu
                                       else inner),
                                  nn.Identity(), nn.Linear(inner, dim)])

    def forward(self, x):
        h = self.net[0].proj(x)
        if self.geglu:
            h, gate = h.chunk(2, dim=-1)
            h = h * F.gelu(gate)
        else:
            h = F.gelu(h)
        return self.net[2](h)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, head_dim: int,
                 context_dim: int | None = None, bias: bool = False,
                 frame_axis: bool = False):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.frame_axis = heads, frame_axis
        self.to_q = nn.Linear(dim, inner, bias=bias)
        self.to_k = nn.Linear(context_dim or dim, inner, bias=bias)
        self.to_v = nn.Linear(context_dim or dim, inner, bias=bias)
        self.to_out = nn.ModuleList([nn.Linear(inner, dim)])

    def forward(self, x, context=None, mask=None):
        ctx = x if context is None else context
        q, k, v = self.to_q(x), self.to_k(ctx), self.to_v(ctx)
        o = (frame_attention(q, k, v, self.heads) if self.frame_axis
             else attention(q, k, v, self.heads, mask))
        return self.to_out[0](o)


class TransformerBlock(nn.Module):
    """LN -> self-attention -> [LN -> cross-attention] -> LN -> FF, each
    residual."""

    def __init__(self, dim: int, heads: int, head_dim: int,
                 context_dim: int | None = None, activation: str = "geglu",
                 bias: bool = False):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = Attention(dim, heads, head_dim, bias=bias)
        self.cross = context_dim is not None
        if self.cross:
            self.norm2 = nn.LayerNorm(dim)
            self.attn2 = Attention(dim, heads, head_dim, context_dim,
                                   bias=bias)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = FeedForward(dim, activation)

    def forward(self, x, context=None, mask=None):
        x = x + self.attn1(self.norm1(x), mask=mask)
        if self.cross:
            x = x + self.attn2(self.norm2(x), context=context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """GroupNorm -> proj_in -> transformer block over each frame's h * w
    tokens (self and cross) -> proj_out -> + input."""

    def __init__(self, channels: int, heads: int, context_dim: int,
                 groups: int):
        super().__init__()
        self.norm = GroupNorm(groups, channels, 1e-6)
        self.proj_in = nn.Linear(channels, channels)
        self.transformer_blocks = nn.ModuleList([TransformerBlock(
            channels, heads, channels // heads, context_dim)])
        self.proj_out = nn.Linear(channels, channels)

    def forward(self, x, context):
        b, f, hh, ww, c = x.shape
        h = self.proj_in(self.norm(x).reshape(b, f, hh * ww, c))
        for block in self.transformer_blocks:
            h = block(h, context=context)
        return self.proj_out(h).reshape(x.shape) + x


class TemporalBlock(nn.Module):
    """n x (LN -> + position code -> attention across frames -> + res),
    then LN -> GEGLU FF -> + res."""

    def __init__(self, dim: int, t: dict):
        super().__init__()
        n = t["attn_layers_per_block"]
        self.max_frames = t["max_frames"]
        self.use_pe = t["use_positional_encoding"]
        self.norms = nn.ModuleList([nn.LayerNorm(dim) for _ in range(n)])
        self.attention_blocks = nn.ModuleList([
            Attention(dim, t["num_heads"], dim // t["num_heads"],
                      frame_axis=True) for _ in range(n)])
        self.ff_norm = nn.LayerNorm(dim)
        self.ff = FeedForward(dim, "geglu")

    def forward(self, x):
        pe = (frame_positions(self.max_frames, x.shape[-1], x.device)
              [:x.shape[1], None, :] if self.use_pe else 0.0)
        for norm, attn in zip(self.norms, self.attention_blocks):
            x = x + attn(norm(x) + pe)
        return x + self.ff(self.ff_norm(x))


class TemporalTransformer(nn.Module):
    def __init__(self, channels: int, t: dict, prior_mode: bool):
        super().__init__()
        self.prior_mode = prior_mode
        if prior_mode:
            self.prior_norm = nn.LayerNorm(channels)
        else:
            self.norm = GroupNorm(32, channels, 1e-6)
        self.proj_in = nn.Linear(channels, channels)
        self.transformer_blocks = nn.ModuleList([
            TemporalBlock(channels, t) for _ in range(t["num_blocks"])])
        self.proj_out = nn.Linear(channels, channels)


class TemporalModule(nn.Module):
    """The motion module: norm -> proj_in -> temporal blocks -> proj_out ->
    + input, over tokens (b, f, n, c) in the prior or maps (b, f, h, w, c)
    in the UNet."""

    def __init__(self, channels: int, t: dict, prior_mode: bool = False):
        super().__init__()
        self.temporal_transformer = TemporalTransformer(channels, t,
                                                        prior_mode)

    def forward(self, x):
        tt = self.temporal_transformer
        if tt.prior_mode:
            h = tt.prior_norm(x)
        else:
            b, f, hh, ww, c = x.shape
            h = tt.norm(x).reshape(b, f, hh * ww, c)
        h = tt.proj_in(h)
        for block in tt.transformer_blocks:
            h = block(h)
        return tt.proj_out(h).reshape(x.shape) + x


# ---- CLIP towers -------------------------------------------------------------

class ClipAttention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, name, nn.Linear(width, width))

    def forward(self, x, mask=None):
        return self.out_proj(attention(self.q_proj(x), self.k_proj(x),
                                       self.v_proj(x), self.heads, mask))


class ClipMLP(nn.Module):
    def __init__(self, width: int, act: str):
        super().__init__()
        self.act = act
        self.fc1 = nn.Linear(width, 4 * width)
        self.fc2 = nn.Linear(4 * width, width)

    def forward(self, x):
        h = self.fc1(x)
        h = h * torch.sigmoid(1.702 * h) if self.act == "quick_gelu" \
            else F.gelu(h)
        return self.fc2(h)


class ClipLayer(nn.Module):
    def __init__(self, width: int, heads: int, act: str):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(width)
        self.self_attn = ClipAttention(width, heads)
        self.layer_norm2 = nn.LayerNorm(width)
        self.mlp = ClipMLP(width, act)

    def forward(self, x, mask=None):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class ClipEncoder(nn.Module):
    def __init__(self, width: int, heads: int, layers: int, act: str):
        super().__init__()
        self.layers = nn.ModuleList([ClipLayer(width, heads, act)
                                     for _ in range(layers)])

    def forward(self, x, mask=None):
        for layer in self.layers:
            x = layer(x, mask)
        return x


class TextTower(nn.Module):
    """ids (n, T) -> (hidden (n, T, width) after the final LayerNorm,
    embeds (n, projection) of the first EOS token's state); causal mask."""

    def __init__(self, c: dict):
        super().__init__()
        self.eos = c["eos_token_id"]
        tm = self.text_model = nn.Module()
        tm.embeddings = nn.Module()
        tm.embeddings.token_embedding = nn.Embedding(c["vocab_size"],
                                                     c["width"])
        tm.embeddings.position_embedding = nn.Embedding(c["max_positions"],
                                                        c["width"])
        tm.encoder = ClipEncoder(c["width"], c["num_heads"],
                                 c["num_layers"], c["hidden_act"])
        tm.final_layer_norm = nn.LayerNorm(c["width"])
        self.text_projection = nn.Linear(c["width"], c["projection_dim"],
                                         bias=False)

    def forward(self, ids):
        tm, t = self.text_model, ids.shape[1]
        h = (tm.embeddings.token_embedding(ids)
             + tm.embeddings.position_embedding.weight[:t])
        causal = torch.full((t, t), float("-inf"), device=h.device).triu(1)
        h = tm.final_layer_norm(tm.encoder(h, causal))
        eos = torch.argmax((ids == self.eos).int(), dim=-1)
        pooled = h[torch.arange(h.shape[0], device=h.device), eos]
        return h, self.text_projection(pooled)


class VisionTower(nn.Module):
    """CLIP-preprocessed pixels (n, H, W, 3) -> (hidden (n, 1 + N, width)
    without the post LayerNorm, embeds (n, projection) of the post-normed
    class token)."""

    def __init__(self, c: dict):
        super().__init__()
        vm = self.vision_model = nn.Module()
        vm.embeddings = nn.Module()
        n_pos = (c["image_size"] // c["patch_size"]) ** 2 + 1
        vm.embeddings.class_embedding = nn.Parameter(torch.zeros(c["width"]))
        vm.embeddings.patch_embedding = Conv(3, c["width"], c["patch_size"],
                                             stride=c["patch_size"],
                                             bias=False)
        vm.embeddings.position_embedding = nn.Embedding(n_pos, c["width"])
        vm.pre_layrnorm = nn.LayerNorm(c["width"])
        vm.encoder = ClipEncoder(c["width"], c["num_heads"],
                                 c["num_layers"], c["hidden_act"])
        vm.post_layernorm = nn.LayerNorm(c["width"])
        self.visual_projection = nn.Linear(c["width"], c["projection_dim"],
                                           bias=False)

    def forward(self, pixels):
        vm, e = self.vision_model, self.vision_model.embeddings
        patches = e.patch_embedding(pixels).flatten(1, 2)
        cls = e.class_embedding.expand(pixels.shape[0], 1, -1)
        h = torch.cat([cls, patches], dim=1) + e.position_embedding.weight
        h = vm.encoder(vm.pre_layrnorm(h))
        return h, self.visual_projection(vm.post_layernorm(h[:, 0]))


# ---- VAE ---------------------------------------------------------------------

class VaeResnet(nn.Module):
    def __init__(self, c_in: int, c_out: int, groups: int):
        super().__init__()
        self.norm1 = GroupNorm(groups, c_in, 1e-6)
        self.conv1 = Conv(c_in, c_out, 3, padding=1)
        self.norm2 = GroupNorm(groups, c_out, 1e-6)
        self.conv2 = Conv(c_out, c_out, 3, padding=1)
        self.conv_shortcut = Conv(c_in, c_out, 1) if c_in != c_out else None

    def forward(self, x):
        h = self.conv2(F.silu(self.norm2(self.conv1(F.silu(self.norm1(x))))))
        return (x if self.conv_shortcut is None else self.conv_shortcut(x)) + h


class VaeAttention(nn.Module):
    """One head over the h * w tokens of the bottleneck."""

    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.group_norm = GroupNorm(groups, ch, 1e-6)
        self.to_q, self.to_k, self.to_v = (nn.Linear(ch, ch) for _ in range(3))
        self.to_out = nn.ModuleList([nn.Linear(ch, ch)])

    def forward(self, x):
        n, h, w, c = x.shape
        y = self.group_norm(x).reshape(n, h * w, c)
        o = attention(self.to_q(y), self.to_k(y), self.to_v(y), 1)
        return x + self.to_out[0](o).reshape(x.shape)


class VaeMid(nn.Module):
    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([VaeResnet(ch, ch, groups)
                                      for _ in range(2)])
        self.attentions = nn.ModuleList([VaeAttention(ch, groups)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


def _holder(**children):
    m = nn.Module()
    for k, v in children.items():
        setattr(m, k, v)
    return m


class VaeEncoder(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        ch, g = c["block_channels"], c["norm_groups"]
        self.conv_in = Conv(c["in_channels"], ch[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        prev = ch[0]
        for level, width in enumerate(ch):
            blk = _holder(resnets=nn.ModuleList([
                VaeResnet(prev if j == 0 else width, width, g)
                for j in range(c["layers_per_block"])]))
            if level != len(ch) - 1:  # SD's (0, 1) pad, then a VALID conv
                blk.downsamplers = nn.ModuleList([_holder(
                    conv=Conv(width, width, 3, stride=2, padding=0))])
            self.down_blocks.append(blk)
            prev = width
        self.mid_block = VaeMid(ch[-1], g)
        self.conv_norm_out = GroupNorm(g, ch[-1], 1e-6)
        self.conv_out = Conv(ch[-1], 2 * c["latent_channels"], 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for blk in self.down_blocks:
            for res in blk.resnets:
                h = res(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0].conv(F.pad(h, (0, 0, 0, 1, 0, 1)))
        h = self.mid_block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class VaeDecoder(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        rev, g = list(reversed(c["block_channels"])), c["norm_groups"]
        self.conv_in = Conv(c["latent_channels"], rev[0], 3, padding=1)
        self.mid_block = VaeMid(rev[0], g)
        self.up_blocks = nn.ModuleList()
        prev = rev[0]
        for level, width in enumerate(rev):
            blk = _holder(resnets=nn.ModuleList([
                VaeResnet(prev if j == 0 else width, width, g)
                for j in range(c["layers_per_block"] + 1)]))
            if level != len(rev) - 1:
                blk.upsamplers = nn.ModuleList([_holder(
                    conv=Conv(width, width, 3, padding=1))])
            self.up_blocks.append(blk)
            prev = width
        self.conv_norm_out = GroupNorm(g, rev[-1], 1e-6)
        self.conv_out = Conv(rev[-1], c["in_channels"], 3, padding=1)

    def forward(self, z):
        h = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            for res in blk.resnets:
                h = res(h)
            if hasattr(blk, "upsamplers"):
                h = h.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
                h = blk.upsamplers[0].conv(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Vae(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        lc = c["latent_channels"]
        self.encoder = VaeEncoder(c)
        self.decoder = VaeDecoder(c)
        self.quant_conv = Conv(2 * lc, 2 * lc, 1)
        self.post_quant_conv = Conv(lc, lc, 1)

    def encode(self, x):
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))


# ---- stage-1 prior -----------------------------------------------------------

NEG = -10000.0  # the prior's additive mask value


class Prior(nn.Module):
    """Per frame, the sequence [text hidden (T) | text embed | known-image
    embed | mask embed | time | x_t | prd token] under a causal and
    caption-padding mask; the prediction is read at the prd token. A
    temporal module follows every transformer block."""

    def __init__(self, c: dict):
        super().__init__()
        inner, d = c["num_heads"] * c["head_dim"], c["embedding_dim"]
        self.c, self.inner = c, inner
        self.seq = c["num_text_tokens"] + 6
        self.time_embedding = TimeMLP(inner, inner)
        for name in ("encoder_hidden_states_proj", "embedding_proj",
                     "embedding_proj1", "embedding_proj2", "proj_in"):
            setattr(self, name, nn.Linear(d, inner))
        self.prd_embedding = nn.Parameter(torch.zeros(1, 1, inner))
        self.positional_embedding = nn.Parameter(
            torch.zeros(1, self.seq, inner))
        blocks = []
        for _ in range(c["num_layers"]):
            blocks.append(TransformerBlock(inner, c["num_heads"],
                                           c["head_dim"], activation="gelu",
                                           bias=True))
            blocks.append(TemporalModule(inner, c["temporal"], True))
        self.transformer_blocks = nn.ModuleList(blocks)
        self.norm_out = nn.LayerNorm(inner)
        self.proj_to_clip_embeddings = nn.Linear(inner, d)

    def forward(self, x_t, t, text_embed, text_hidden, image_embed,
                mask_embed, text_mask):
        b, f, _ = x_t.shape
        inner = self.inner
        temb = self.time_embedding(timestep_sinusoid(t.reshape(b * f), inner))
        h = torch.cat([
            self.encoder_hidden_states_proj(text_hidden),
            self.embedding_proj(text_embed)[:, :, None],
            self.embedding_proj1(image_embed)[:, :, None],
            self.embedding_proj2(mask_embed)[:, :, None],
            temb.reshape(b, f, 1, inner),
            self.proj_in(x_t)[:, :, None],
            self.prd_embedding.expand(b, f, 1, inner),
        ], dim=2) + self.positional_embedding
        causal = torch.full((self.seq, self.seq), NEG,
                            device=h.device).triu(1)
        pad = F.pad((1.0 - text_mask.float()) * NEG,
                    (0, self.seq - text_mask.shape[-1]))
        mask = pad[:, :, None, None, :] + causal
        for i in range(0, len(self.transformer_blocks), 2):
            h = self.transformer_blocks[i](h, mask=mask)
            h = self.transformer_blocks[i + 1](h)
        return self.proj_to_clip_embeddings(self.norm_out(h)[:, :, -1])


# ---- stage-2 UNet ------------------------------------------------------------

class Resnet(nn.Module):
    """GN -> SiLU -> conv3x3 -> + time projection -> GN -> SiLU -> conv3x3,
    with a 1x1 shortcut where the width changes."""

    def __init__(self, c_in: int, c_out: int, temb: int, groups: int,
                 eps: float):
        super().__init__()
        self.norm1 = GroupNorm(groups, c_in, eps)
        self.conv1 = Conv(c_in, c_out, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb, c_out)
        self.norm2 = GroupNorm(groups, c_out, eps)
        self.conv2 = Conv(c_out, c_out, 3, padding=1)
        self.conv_shortcut = Conv(c_in, c_out, 1) if c_in != c_out else None

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, None, None, None, :]
        h = self.conv2(F.silu(self.norm2(h)))
        return (x if self.conv_shortcut is None else self.conv_shortcut(x)) + h


class Level(nn.Module):
    def __init__(self, c: dict, ins: list, out: int, temb: int, cross: bool,
                 resample: str | None):
        super().__init__()
        g, heads = c["norm_groups"], c["num_attention_heads"]
        self.resnets = nn.ModuleList([Resnet(i, out, temb, g, c["norm_eps"])
                                      for i in ins])
        self.attentions = nn.ModuleList(
            [SpatialTransformer(out, heads, c["cross_attention_dim"], g)
             for _ in ins] if cross else [])
        self.motion_modules = nn.ModuleList([TemporalModule(
            out, c["temporal"]) for _ in ins])
        if resample == "down":
            self.downsamplers = nn.ModuleList([_holder(
                conv=Conv(out, out, 3, stride=2, padding=1))])
        elif resample == "up":
            self.upsamplers = nn.ModuleList([_holder(
                conv=Conv(out, out, 3, padding=1))])

    def sub_block(self, j, x, temb, context):
        x = self.resnets[j](x, temb)
        if len(self.attentions):
            x = self.attentions[j](x, context)
        return self.motion_modules[j](x)


class UNet(nn.Module):
    """(noisy | mask | masked-source latents) (b, f, h, w, 9), timestep,
    context (b, f, T, 768) -> epsilon (b, f, h, w, 4)."""

    def __init__(self, c: dict):
        super().__init__()
        ch, n = c["block_channels"], len(c["block_channels"])
        self.ch0, temb = ch[0], 4 * ch[0]
        self.time_embedding = TimeMLP(ch[0], temb)
        self.conv_in = Conv(c["in_channels"], ch[0], 3, padding=1)
        lpb = c["layers_per_block"]
        skips, prev = [ch[0]], ch[0]
        self.down_blocks = nn.ModuleList()
        for level, width in enumerate(ch):
            last = level == n - 1
            self.down_blocks.append(Level(
                c, [prev] + [width] * (lpb - 1), width, temb,
                c["cross_attn_levels"][level], None if last else "down"))
            skips += [width] * (lpb + (0 if last else 1))
            prev = width
        mid = ch[-1]
        self.mid_block = _holder(
            resnets=nn.ModuleList([Resnet(mid, mid, temb, c["norm_groups"],
                                          c["norm_eps"]) for _ in range(2)]),
            attentions=nn.ModuleList([SpatialTransformer(
                mid, c["num_attention_heads"], c["cross_attention_dim"],
                c["norm_groups"])]))
        self.up_blocks = nn.ModuleList()
        rev, rev_cross = list(reversed(ch)), list(reversed(
            c["cross_attn_levels"]))
        h_ch = mid
        for level, width in enumerate(rev):
            ins = []
            for _ in range(lpb + 1):
                ins.append(h_ch + skips.pop())
                h_ch = width
            self.up_blocks.append(Level(c, ins, width, temb,
                                        rev_cross[level],
                                        None if level == n - 1 else "up"))
        self.conv_norm_out = GroupNorm(c["norm_groups"], ch[0], c["norm_eps"])
        self.conv_out = Conv(ch[0], c["out_channels"], 3, padding=1)

    def forward(self, x, t, context):
        temb = self.time_embedding(timestep_sinusoid(t, self.ch0))
        h = self.conv_in(x)
        skips = [h]
        for blk in self.down_blocks:
            for j in range(len(blk.resnets)):
                h = blk.sub_block(j, h, temb, context)
                skips.append(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0].conv(h)
                skips.append(h)
        mb = self.mid_block
        h = mb.resnets[1](mb.attentions[0](mb.resnets[0](h, temb), context),
                          temb)
        for blk in self.up_blocks:
            for j in range(len(blk.resnets)):
                h = blk.sub_block(j, torch.cat([h, skips.pop()], dim=-1),
                                  temb, context)
            if hasattr(blk, "upsamplers"):
                h = h.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
                h = blk.upsamplers[0].conv(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


# ---- fusion ------------------------------------------------------------------

class PackedAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x, context):
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        return self.out_proj(attention(F.linear(x, wq, bq),
                                       F.linear(context, wk, bk),
                                       F.linear(context, wv, bv),
                                       self.heads))


class CrossStack(nn.Module):
    def __init__(self, c: dict, vis_dim: int):
        super().__init__()
        self.text_fc = nn.Linear(c["text_dim"], c["hidden_dim"])
        self.vis_fc = nn.Linear(vis_dim, c["hidden_dim"])
        self.multihead_attn = PackedAttention(c["hidden_dim"], c["num_heads"])

    def forward(self, vis, text):
        return self.multihead_attn(self.text_fc(text), self.vis_fc(vis))


class Fusion(nn.Module):
    """The UNet's context: text tokens attending to the known frame's CLIP
    tokens (seen) or to the stage-1 embedding (unseen), picked per
    frame."""

    def __init__(self, c: dict):
        super().__init__()
        self.seen_module = CrossStack(c, c["seen_vis_dim"])
        self.unseen_module = CrossStack(c, c["unseen_vis_dim"])

    def forward(self, image_tokens, image_proj, text_hidden, known):
        seen = self.seen_module(image_tokens, text_hidden)
        unseen = self.unseen_module(image_proj[:, :, None, :], text_hidden)
        return torch.where(known[:, :, None, None], seen, unseen)


class Story(nn.Module):
    """The towers under their parameter-key names."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.text_s1 = TextTower(cfg["text_s1"])
        self.text_s2 = TextTower(cfg["text_s2"])
        self.vision = VisionTower(cfg["vision"])
        self.vae = Vae(cfg["vae"])
        self.prior = Prior(cfg["prior"])
        self.unet = UNet(cfg["unet"])
        self.fusion = Fusion(cfg["fusion"])
