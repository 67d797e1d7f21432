"""The yardstick's arithmetic: the card's peaks, the least time a piece of
work can take on it, the work of one attention or feed-forward call from
its argument shapes, and a story's model FLOPs from the configuration's
shapes.

The peaks and `bound_s` are a frozen copy of the port's
`rcdms_tpu_torch/tools/__init__.py::bound_ms` arithmetic: one H100 SXM at
its 700 W limit, dense bf16 989 TFLOP/s, HBM3 3.35 TB/s, and MUFU.EX2 at 16
an SM a clock on 132 SMs at 1980 MHz. Every input byte is read once and
every output byte written once.

A story's FLOPs count every product of the model (linear layers, convs,
the two products of each attention) at 2 FLOPs a multiply-add, as
`torch.utils.flop_counter.FlopCounterMode` counts them: the same whatever
implements the layer. Elementwise work, norms and softmax are not counted.
"""

from __future__ import annotations

PEAK_FLOPS = {2: 989e12, 4: 67e12}  # by operand size in bytes: bf16, fp32
PEAK_BYTES = 3.35e12
PEAK_EXPS = 132 * 16 * 1.98e9


def bound_s(flops: float = 0.0, exps: float = 0.0, nbytes: float = 0.0,
            itemsize: int = 2) -> float:
    """The least time the card could take for the work, in seconds."""
    return max(flops / PEAK_FLOPS[itemsize], exps / PEAK_EXPS,
               nbytes / PEAK_BYTES)


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


def attention(q_shape, k_shape, heads: int, itemsize: int,
              mask_bytes=None) -> dict:
    """One call of token-major attention: q (..., Sq, H dh), k and v
    (..., Skv, H dh), an optional additive mask. Two products, one
    exponential a score; q, k, v, the mask read once, the output written
    once."""
    sq, c = q_shape[-2], q_shape[-1]
    skv = k_shape[-2]
    batch = _prod(q_shape[:-2])
    scores = batch * heads * sq * skv
    nbytes = (2 * batch * sq * c + 2 * batch * skv * c) * itemsize
    return dict(flops=4.0 * scores * (c // heads), exps=float(scores),
                nbytes=float(nbytes + (mask_bytes or 0)), itemsize=itemsize)


def ff(rows: int, c: int, up: int, inner: int, itemsize: int) -> dict:
    """One fused feed-forward call: x (rows, c) -> up projection (c, up)
    -> activation -> down projection (inner, c). x, the weights and biases
    read once, the output written once (the activation stays on chip),
    all in the weights' dtype (the port's FF casts x to it)."""
    flops = 2.0 * rows * c * up + 2.0 * rows * inner * c
    nbytes = (2 * rows * c + up * c + up + c * inner + c) * itemsize
    return dict(flops=flops, exps=0.0, nbytes=float(nbytes),
                itemsize=itemsize)


def share(calls: list, device_s: float):
    """Sum of the calls' least times over the device seconds spent on
    them, in %; None where nothing was read."""
    if not calls or device_s <= 0:
        return None
    least = sum(bound_s(c["flops"], c["exps"], c["nbytes"], c["itemsize"])
                for c in calls)
    return 100.0 * least / device_s


# ---- a story's model FLOPs ---------------------------------------------------

def _encoder(rows: int, tokens: int, width: int, layers: int) -> float:
    """A pre-norm transformer encoder: q, k, v, out, the 4x MLP and the
    two attention products."""
    per = 24.0 * rows * tokens * width ** 2 + 4.0 * rows * tokens ** 2 * width
    return layers * per


def text_tower(c: dict, rows: int) -> float:
    t, w = c["max_positions"], c["width"]
    return (_encoder(rows, t, w, c["num_layers"])
            + 2.0 * rows * w * c["projection_dim"])


def vision_tower(c: dict, rows: int) -> float:
    grid = (c["image_size"] // c["patch_size"]) ** 2
    w = c["width"]
    patch = 2.0 * rows * grid * w * 3 * c["patch_size"] ** 2
    return (patch + _encoder(rows, grid + 1, w, c["num_layers"])
            + 2.0 * rows * w * c["projection_dim"])


def _conv(n: int, h: int, w: int, cin: int, cout: int, k: int) -> float:
    return 2.0 * n * h * w * cout * cin * k * k


def _geglu(n: int, c: int) -> float:
    return 24.0 * n * c * c


def _temporal(stories: int, frames: int, tokens: int, c: int,
              t: dict) -> float:
    """A temporal module over `stories` x `frames` x `tokens` tokens."""
    n = stories * frames * tokens
    layer = 8.0 * n * c * c + 4.0 * stories * tokens * frames ** 2 * c
    block = t["attn_layers_per_block"] * layer + _geglu(n, c)
    return 4.0 * n * c * c + t["num_blocks"] * block


def prior_call(c: dict, rows: int, frames: int) -> float:
    """One prior forward over `rows` = stories x frames sequences."""
    inner, d = c["num_heads"] * c["head_dim"], c["embedding_dim"]
    s, t = c["num_text_tokens"] + 6, c["num_text_tokens"]
    embed = 2.0 * rows * t * d * inner + 4 * 2.0 * rows * d * inner
    time = 2 * 2.0 * rows * inner * inner
    block = (8.0 * rows * s * inner ** 2 + 4.0 * rows * s * s * inner
             + 16.0 * rows * s * inner ** 2)
    temporal = _temporal(rows // frames, frames, s, inner, c["temporal"])
    return (embed + time + c["num_layers"] * (block + temporal)
            + 2.0 * rows * inner * d)


def _resnet(n: int, hw: int, cin: int, cout: int, temb: int,
            stories: int) -> float:
    out = (_conv(n, hw, hw, cin, cout, 3) + _conv(n, hw, hw, cout, cout, 3)
           + (2.0 * n * hw * hw * cout * cin if cin != cout else 0.0))
    return out + (2.0 * stories * temb * cout if temb else 0.0)


def _spatial(n: int, hw: int, c: int, ctx_tokens: int, ctx_dim: int
             ) -> float:
    tok = n * hw * hw
    return (4.0 * tok * c * c                      # proj_in, proj_out
            + 8.0 * tok * c * c + 4.0 * n * (hw * hw) ** 2 * c
            + 4.0 * tok * c * c + 4.0 * n * ctx_tokens * ctx_dim * c
            + 4.0 * n * hw * hw * ctx_tokens * c
            + _geglu(tok, c))


def unet_call(c: dict, stories: int, frames: int, hw: int,
              ctx_tokens: int) -> float:
    """One UNet forward over `stories` stories of `frames` latent maps of
    hw x hw."""
    n = stories * frames
    ch, lpb = c["block_channels"], c["layers_per_block"]
    temb, ctx = 4 * ch[0], c["cross_attention_dim"]
    t = c["temporal"]
    total = 2.0 * stories * ch[0] * temb + 2.0 * stories * temb * temb
    total += _conv(n, hw, hw, c["in_channels"], ch[0], 3)

    def sub(cin, cout, size, cross):
        out = _resnet(n, size, cin, cout, temb, stories)
        if cross:
            out += _spatial(n, size, cout, ctx_tokens, ctx)
        return out + _temporal(stories, frames, size * size, cout, t)

    skips, prev, size = [ch[0]], ch[0], hw
    for level, width in enumerate(ch):
        for j in range(lpb):
            total += sub(prev if j == 0 else width, width, size,
                         c["cross_attn_levels"][level])
            skips.append(width)
        prev = width
        if level != len(ch) - 1:
            size //= 2
            total += _conv(n, size, size, width, width, 3)
            skips.append(width)
    mid = ch[-1]
    total += 2 * _resnet(n, size, mid, mid, temb, stories)
    total += _spatial(n, size, mid, ctx_tokens, ctx)
    h_ch = mid
    rev, rev_cross = ch[::-1], c["cross_attn_levels"][::-1]
    for level, width in enumerate(rev):
        for _ in range(lpb + 1):
            total += sub(h_ch + skips.pop(), width, size, rev_cross[level])
            h_ch = width
        if level != len(rev) - 1:
            size *= 2
            total += _conv(n, size, size, width, width, 3)
    return total + _conv(n, hw, hw, ch[0], c["out_channels"], 3)


def _vae_resnet(n, hw, cin, cout) -> float:
    return _resnet(n, hw, cin, cout, 0, 0)


def _vae_mid(n, hw, c) -> float:
    tok = hw * hw
    return (2 * _vae_resnet(n, hw, c, c) + 8.0 * n * tok * c * c
            + 4.0 * n * tok * tok * c)


def vae_encode(c: dict, images: int, size: int) -> float:
    ch, lpb, lc = c["block_channels"], c["layers_per_block"], \
        c["latent_channels"]
    total = _conv(images, size, size, c["in_channels"], ch[0], 3)
    prev = ch[0]
    for level, width in enumerate(ch):
        for j in range(lpb):
            total += _vae_resnet(images, size, prev if j == 0 else width,
                                 width)
        prev = width
        if level != len(ch) - 1:
            size //= 2
            total += _conv(images, size, size, width, width, 3)
    total += _vae_mid(images, size, ch[-1])
    total += _conv(images, size, size, ch[-1], 2 * lc, 3)
    return total + _conv(images, size, size, 2 * lc, 2 * lc, 1)


def vae_decode(c: dict, images: int, size: int) -> float:
    rev, lpb, lc = c["block_channels"][::-1], c["layers_per_block"], \
        c["latent_channels"]
    total = (_conv(images, size, size, lc, lc, 1)
             + _conv(images, size, size, lc, rev[0], 3)
             + _vae_mid(images, size, rev[0]))
    prev = rev[0]
    for level, width in enumerate(rev):
        for j in range(lpb + 1):
            total += _vae_resnet(images, size, prev if j == 0 else width,
                                 width)
        prev = width
        if level != len(rev) - 1:
            size *= 2
            total += _conv(images, size, size, width, width, 3)
    return total + _conv(images, size, size, rev[-1], c["in_channels"], 3)


def fusion(c: dict, rows: int, text_tokens: int, vis_tokens: int) -> float:
    """Both stacks (seen and unseen) over `rows` frames, once."""
    h = c["hidden_dim"]
    total = 0.0
    for vis_dim, nv in ((c["seen_vis_dim"], vis_tokens),
                        (c["unseen_vis_dim"], 1)):
        total += (2.0 * rows * text_tokens * c["text_dim"] * h
                  + 2.0 * rows * nv * vis_dim * h
                  + 4.0 * rows * text_tokens * h * h        # q, out
                  + 4.0 * rows * nv * h * h                 # k, v
                  + 4.0 * rows * text_tokens * nv * h)
    return total


def story_flops(cfg: dict, stories: int = 1, cached: bool = True) -> dict:
    """The model FLOPs of one `generate` call over `stories` stories, by
    stage. `cached`: with the story-independent conditioning (the
    negative prompt through both text towers, the mask images through the
    vision tower) worked out once beforehand, as a warm CondCache has it;
    else once a story, as the plain reference computes it."""
    f, size = cfg["num_frames"], cfg["image_size"]
    rows = stories * f
    vae = cfg["vae"]
    hw = size // 2 ** (len(vae["block_channels"]) - 1)
    t2 = cfg["text_s2"]["max_positions"]
    vis = (cfg["vision"]["image_size"] // cfg["vision"]["patch_size"]) ** 2 + 1
    cfg_rows = 2 if cfg["guidance_scale"] > 1.0 else 1
    out = {
        "text": text_tower(cfg["text_s1"], rows) + text_tower(cfg["text_s2"],
                                                              rows),
        "vision": vision_tower(cfg["vision"], rows),
        "prior": cfg["prior_steps"] * prior_call(cfg["prior"],
                                                 cfg_rows * rows, f),
        "vae": vae_encode(vae, rows, size) + vae_decode(vae, rows, hw),
        "fusion": cfg_rows * fusion(cfg["fusion"], rows, t2, vis),
        "unet": cfg["ddim_steps"] * cfg_rows * unet_call(cfg["unet"], stories,
                                                         f, hw, t2),
    }
    if not cached:
        out["text"] *= 2
        out["vision"] *= 2
    return out
