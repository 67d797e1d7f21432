"""Story/video export and DDIM inversion — the counterpart of
`rcdms_tpu/utils/video.py` (the reference's `src/utils/util.py`,
`save_videos_grid` and `ddim_inversion`).

Pillow is imported inside `save_videos_grid` alone: a machine without it
(the card machine) imports this module and runs `ddim_inversion`, and only
the GIF writer raises there."""

from __future__ import annotations

import os
from typing import Callable

import numpy as np
import torch


def save_videos_grid(videos, path: str, n_rows: int = 4,
                     fps: int = 2) -> None:
    """videos: (b, f, h, w, 3) floats in [0, 1], a numpy array or a tensor.
    Writes an animated GIF whose frames are grids of the b stories, up to
    `n_rows` of them in a row of the grid (the JAX function's layout),
    each frame shown int(1000 / fps) ms, looping. Raises ImportError
    without Pillow."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("save_videos_grid writes its GIF with Pillow, "
                          "which is not installed") from e

    if isinstance(videos, torch.Tensor):
        videos = videos.detach().float().cpu().numpy()
    videos = np.asarray(videos)
    b, f, h, w, _ = videos.shape
    cols = min(n_rows, b)
    rows = (b + cols - 1) // cols
    frames = []
    for t in range(f):
        grid = np.zeros((rows * h, cols * w, 3), np.float32)
        for i in range(b):
            r, c = divmod(i, cols)
            grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = videos[i, t]
        frames.append(Image.fromarray(
            (np.clip(grid, 0, 1) * 255).astype(np.uint8)))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    frames[0].save(path, save_all=True, append_images=frames[1:],
                   duration=int(1000 / fps), loop=0)


@torch.no_grad()
def ddim_inversion(denoise_fn: Callable, schedule, latents: torch.Tensor,
                   num_steps: int = 50) -> torch.Tensor:
    """Deterministic DDIM inversion x_0 -> x_T: the DDIM update with the
    timestep chain reversed, each step's "next" the following larger
    timestep and the last one `num_train_timesteps - 1`.

    denoise_fn(latents, t) -> the epsilon prediction at the int timestep
    t. `schedule`: a `core.schedulers.DDIMSchedule`, whose float64
    alphas_cumprod are rounded to fp32 as the JAX function's are. The
    update runs in fp32 on `latents.device`; returns fp32 latents of
    `latents`' shape."""
    ts = schedule.timesteps(num_steps)[::-1]            # ascending
    nxt = np.concatenate([ts[1:], [schedule.num_train_timesteps - 1]])
    acp = torch.as_tensor(schedule.alphas_cumprod, dtype=torch.float32,
                          device=latents.device)
    lat = latents.float()
    for t, n in zip(ts.tolist(), nxt.tolist()):
        eps = denoise_fn(lat, t).float()
        a_t, a_n = acp[t], acp[n]
        x0 = (lat - torch.sqrt(1 - a_t) * eps) / torch.sqrt(a_t)
        lat = torch.sqrt(a_n) * x0 + torch.sqrt(1 - a_n) * eps
    return lat
