"""Sharded single-story inference in the port (`--shard-story`) on the CPU:
gloo ranks (`torch.multiprocessing`, spawned, one torch thread each, a
`FileStore` rendezvous under the test's temporary directory) against one
process.

One pool of 8 processes runs the meshes in turn, each a process group of
its own (`_rank_main`): worlds 2 (cfg 2), 3 (space 3), 4 (cfg 2 x space
2), 6 (cfg 2 x space 3), 8 (cfg 2 x space 4), and at a 'frame' axis of 2
worlds 4 (cfg 2 x frame 2) and 8 (cfg 2 x frame 2 x space 2), while the
references run here:

* the tiny fp32 pipeline (UNet channels (64, 128), 32 px: 16 latent rows
  in 8 granules of 2, so worlds 3 and 6 split them 6 / 6 / 4; 5 frames
  over 2 ranks 3 / 2; the towers' 5 images over 6 or 8 ranks leave ranks
  with none, as the prior's 5 frames over 4 do), seeded and perturbed
  weights: `generate`, `generate_stage1_autoreg`, a batch of 2 stories,
  encoder propagation k = 2 and DDIM eta 0.5 (step noise kept by frames
  and rows) equal the one-process port within atol 5e-5, rtol 1e-5 (the
  JAX test's tolerance, `tests/test_sharded_inference.py`), and every
  rank holds the same whole story; at world 4 the frames equal the JAX
  package's unsharded story (`tests/test_torch_pipeline.py`'s self_test
  weights and noise) within its FRAME_TOL, and at world 6 and at world 4
  with frame 2 the JAX package's sharded story on the same mesh
  (`rcdms_tpu.train.sharding.inference_mesh`) with its key's draws;
* each rank's towers see its block of the b*f batch, its prior its block
  of the frames, and every temporal attention (kernel B) every frame of a
  block of tokens;
* module cases at worlds 2, 3 and 4, each a layer split over every rank
  against the whole-tensor layer: the 3x3 conv (also on 2 rows, where a
  rank holds none), the UNet's and the VAE's stride-2 downsamples (the
  VAE's also on 13 rows, an odd last block), the upsample, GroupNorm (also
  on 2 rows), the spatial transformer (K/V gathered), the VAE's mid
  attention, the int8 conv (its scale a MAX over the ranks; rows, and
  frames split), and the temporal module, UNet's and prior's, with its
  frames split (frames traded for tokens);
* in int8 quant mode at worlds 4 and 4 at frame 2, sequential and
  batched CFG: every int8 conv's activation scale in the story's first
  step is one process's (INT8_SCALE_RTOL);
* a 256-query attention site split two ways still routes to kernel A;
* `evaluate --shard-story --device cpu` on 2 ranks writes the one-process
  run's PNGs and metrics, from rank 0 alone;
* at world 4, a 36 px story (18 latent rows: blocks 10 / 10 / 10 / 6 of
  pixel rows, 10 / 8 of latent rows) equals one process, and a 34 px one
  (17 latent rows, which no UNet halves) raises with the world size.

Here, in this process: `mesh_shape` against the JAX `inference_mesh` for
1-8 devices at 'frame' 1-4, the full-width split plan at every world, the
rows `check_rows` refuses, the router's whole query count, and a one-rank
mesh (a one-rank gloo group) equal to no mesh bit for bit.
"""

import json
import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from rcdms_tpu_torch.cli import evaluate as pevaluate
from rcdms_tpu_torch.configs import StoryUNetConfig, TemporalConfig, VAEConfig
from rcdms_tpu_torch.core import spatial
from rcdms_tpu_torch.core.attention import Attention, SpatialTransformer
from rcdms_tpu_torch.core.layers import (
    Conv,
    FrameConv,
    GroupNorm,
    init_like_flax_,
)
from rcdms_tpu_torch.core.resnet import Downsample, Upsample
from rcdms_tpu_torch.core.temporal import TemporalModule
from rcdms_tpu_torch.models.vae import VAEAttnBlock, encoder_downsample
from rcdms_tpu_torch.ops import attention as attention_ops
from rcdms_tpu_torch.ops import quant
from rcdms_tpu_torch.sample.eval import decode_png
from rcdms_tpu_torch.sample.pipeline import (
    StoryNoise,
    StoryPipeline,
    tiny_configs,
    tiny_inputs,
)
from rcdms_tpu_torch.train import distributed, sharding
from tests.test_torch_configs import (  # noqa: F401 (autouse fixture)
    one_torch_thread,
)

# (world, frame) of each mesh the pool runs, in turn
MESHES = ((2, 1), (3, 1), (4, 1), (6, 1), (8, 1), (4, 2), (8, 2))
MODULE_WORLDS = (2, 3, 4)
JAX_WORLD = 4
JAX_MESHES = ((6, 1), (4, 2))  # compared with the JAX package's sharded story
SHARE_MESHES = ((6, 1), (8, 2))  # where each rank's share is counted
POOL = max(w for w, _ in MESHES)
JOIN_S = 300  # seconds the pool may take for every mesh's jobs
STEPS = 2
UNET_CHANNELS = (64, 128)  # tests/test_torch_pipeline.py's self_test's
TOL = dict(atol=5e-5, rtol=1e-5)
JOBS = ("generate", "autoreg", "batch2", "k2", "eta")
INT8_MESHES = ((4, 1), (4, 2))  # where the int8 scales are compared
# the int8 scales' relative tolerance in a story's first step: sound
# 5.5e-3-7.9e-3 off one process (rounding flips), a scale of this rank's
# block alone 0.16-0.22
INT8_SCALE_RTOL = 3e-2
CLI_ARGS = ["--synthetic", "--device", "cpu", "--num-stories", "2",
            "--num-inference-steps", "2"]


def _mesh_id(mesh) -> str:
    world, frame = mesh
    return str(world) if frame == 1 else f"{world}-frame{frame}"


def _pipeline(mesh=None, **options) -> StoryPipeline:
    """The tiny pipeline with tests/test_torch_pipeline.py's weights:
    flax-like init from seed 0, each parameter perturbed by 0.05 randn."""
    pipe = StoryPipeline(tiny_configs(unet_channels=UNET_CHANNELS),
                         num_steps=STEPS, mesh=mesh, **options)
    g = torch.Generator().manual_seed(0)
    init_like_flax_(pipe, g)
    with torch.no_grad():
        for p in pipe.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    return pipe.eval()


def _story(configs, seed: int, pixels: int = 32):
    """`tiny_inputs` with seeded random source pixels in [-1, 1]."""
    inputs = tiny_inputs(configs, seed)
    shape = inputs.source_pixels.shape[:2] + (pixels, pixels, 3)
    px = np.random.RandomState(seed).uniform(-1, 1, shape)
    return inputs._replace(source_pixels=torch.from_numpy(
        px.astype(np.float32)))


def _batch(configs):
    """Stories 1 and 2 stacked along b."""
    a, b = _story(configs, 1), _story(configs, 2)
    return type(a)(*(torch.cat([x, y]) for x, y in zip(a, b)))


def _noise(pipe, *seeds, pixels: int = 32) -> StoryNoise:
    return StoryNoise.cat(StoryNoise.draw(
        pipe, 1, torch.Generator().manual_seed(s), pixels) for s in seeds)


def _jax_noise(pipe) -> StoryNoise:
    """self_test's draws (RandomState(42): prior init, prior steps, VAE,
    story init) for one tiny story."""
    f, d = 5, pipe.configs.prior.embedding_dim
    rng = np.random.RandomState(42)
    shapes = ((1, f, d), (STEPS, 1, f, d), (f, 16, 16, 4), (1, f, 16, 16, 4))
    return StoryNoise(*(torch.from_numpy(rng.randn(*s).astype(np.float32))
                        for s in shapes))


def _jax_key_noise() -> StoryNoise:
    """The draws of the JAX `StoryPipeline.generate` from PRNGKey(1) for
    one tiny story (its prior's init and step noise from key1, the VAE's
    from key_vae, its story sampler's init from key2)."""
    import jax

    f, d, lat = 5, tiny_configs().prior.embedding_dim, (16, 16, 4)
    key1, key2, key_vae = jax.random.split(jax.random.PRNGKey(1), 3)
    key, init_key = jax.random.split(key1)
    prior_init = jax.random.normal(init_key, (1, f, d))
    prior_steps = np.stack([
        np.asarray(jax.random.normal(jax.random.fold_in(key, i), (1, f, d)))
        for i in range(STEPS)])
    vae = jax.random.normal(key_vae, (f,) + lat)
    story_init = jax.random.normal(jax.random.split(key2)[1], (1, f) + lat)
    return StoryNoise(*(torch.from_numpy(np.array(a, np.float32))
                        for a in (prior_init, prior_steps, vae, story_init)))


def _white(configs) -> torch.Tensor:
    c = configs.vision.image_size
    return torch.full((c, c, 3), 0.75)


def _story_jobs(mesh) -> dict:
    """The pipeline outputs every mesh is compared on: name -> tensors
    (k2: encoder propagation k = 2; eta: DDIM eta 0.5, a step noise a
    step)."""
    pipe = _pipeline(mesh)
    k2 = _pipeline(mesh, encoder_propagation=2)
    eta = _pipeline(mesh, eta=0.5)
    configs = pipe.configs
    story = _story(configs, 1)
    return {
        "generate": pipe.generate(story, noise=_noise(pipe, 11)),
        "autoreg": (pipe.generate_stage1_autoreg(
            story, _white(configs),
            generator=torch.Generator().manual_seed(13)),),
        "batch2": pipe.generate(_batch(configs),
                                noise=_noise(pipe, 21, 22)),
        "k2": k2.generate(story, noise=_noise(k2, 11)),
        "eta": eta.generate(story, noise=_noise(eta, 11)),
    }


def _int8_jobs(mesh) -> dict:
    """The story in int8 quant mode (`ops/quant.py`: the tiny UNet's 3x3
    convs of 64 and 128 input channels take the int8 route), its CFG
    branches run one after the other (the default) and batched: cfg ->
    the activation scale of each int8 conv call, in call order."""
    real = quant.quantize_act
    scales = []

    def recorded(x):
        q, scale = real(x)
        scales.append(scale.item())
        return q, scale

    quant.set_quant_mode("int8")
    quant.quantize_act = recorded
    try:
        out = {}
        for cfg, sequential in (("sequential", True), ("batched", False)):
            scales.clear()
            pipe = _pipeline(mesh, sequential_cfg=sequential)
            pipe.generate(_story(pipe.configs, 1), noise=_noise(pipe, 11))
            out[cfg] = torch.tensor(scales, dtype=torch.float64)
        return out
    finally:
        quant.quantize_act = real
        quant.set_quant_mode(None)


def _module_cases() -> dict:
    """name -> (function of a feature map and args, the whole input (rows
    at dim -3, or frames at dim 1), args, the split: a `RowPlan`'s
    (levels, up) or "frames"), seeded from numpy (inputs) and a torch
    generator (weights, perturbed so that no bias stays zero)."""
    g = torch.Generator().manual_seed(5)
    rs = np.random.RandomState(0)

    def built(m):
        init_like_flax_(m, g)
        with torch.no_grad():
            for p in m.parameters():
                p.add_(0.1 * torch.randn(p.shape, generator=g))
        return m.eval()

    def x(*shape):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32))

    conv = built(Conv(8, 8, 3, padding=1))
    vae_down = built(Conv(8, 8, 3, stride=2, padding=0))
    norm = built(GroupNorm(4, 16))
    int8 = built(FrameConv(64, 64, 3, padding=1))
    temporal = TemporalConfig(num_heads=2, num_blocks=1)

    def int8_conv(h):
        quant.set_quant_mode("int8")
        try:
            return int8(h)
        finally:
            quant.set_quant_mode(None)

    def down(h):
        return encoder_downsample(vae_down, h)

    return {
        "conv3x3": (conv, x(2, 16, 8, 8), (), (1, 0)),
        "conv3x3_2_rows": (conv, x(2, 2, 8, 8), (), (1, 0)),
        "unet_downsample": (built(Downsample(8)), x(1, 2, 16, 8, 8), (),
                            (2, 0)),
        "vae_downsample": (down, x(2, 16, 8, 8), (), (2, 0)),
        "vae_downsample_13_rows": (down, x(2, 13, 8, 8), (), (2, 0)),
        "upsample": (built(Upsample(8)), x(1, 2, 16, 8, 8), (), (1, 1)),
        "group_norm": (norm, x(1, 2, 16, 8, 16), (), (1, 0)),
        "group_norm_2_rows": (norm, x(1, 2, 2, 8, 16), (), (1, 0)),
        "spatial_transformer": (
            built(SpatialTransformer(32, 2, 16, 24, norm_groups=8)),
            x(1, 2, 16, 8, 32), (x(1, 2, 7, 24),), (1, 0)),
        "vae_attention": (built(VAEAttnBlock(16, 4)), x(2, 16, 8, 16), (),
                          (1, 0)),
        "int8_conv": (int8_conv, x(1, 2, 16, 4, 64), (), (1, 0)),
        "int8_conv_frames": (int8_conv, x(1, 5, 4, 4, 64), (), "frames"),
        "temporal": (built(TemporalModule(32, temporal)),
                     x(1, 5, 4, 4, 32), (), "frames"),
        "temporal_prior": (built(TemporalModule(32, temporal,
                                                prior_mode=True)),
                           x(1, 5, 7, 32), (), "frames"),
    }


def _split_module(fn, x, args, split, group):
    """The module case run split over `group`, its output gathered
    whole."""
    if split == "frames":
        table = spatial.blocks(x.shape[1], group.size)
        with spatial.spatial(frames=spatial.FrameSplit(group, x.shape[1]),
                             whole=group):
            y = fn(spatial.narrow(x, 1, group, table), *args)
        return spatial.gather(y, 1, group, table)
    rows = x.dim() - 3
    plan = spatial.RowPlan(group, x.shape[rows], x.shape[rows + 1], *split)
    with spatial.spatial(plan):
        y = fn(spatial.narrow(x, rows, group, plan.blocks(x.shape[-2])),
               *args)
    return spatial.gather(y, rows, group, plan.blocks(y.shape[-2]))


def _attention_site(queries: int):
    """A seeded self-attention (2 heads of 16) and its (1, queries, 32)
    token input, a map of 16 columns."""
    g = torch.Generator().manual_seed(9)
    attn = Attention(32, 2, 16)
    init_like_flax_(attn, g)
    x = torch.from_numpy(np.random.RandomState(queries).randn(
        1, queries, 32).astype(np.float32))
    return attn.eval(), x


def _routed_split(group, queries: int):
    """(output gathered whole, local query counts that reached
    `flash_attention`) of the site split over `group`."""
    attn, x = _attention_site(queries)
    plan = spatial.RowPlan(group, queries // 16, 16)
    routed = []
    real = attention_ops.flash_attention

    def record(q, *a, **kw):
        routed.append(q.shape[-2])
        return real(q, *a, **kw)

    attention_ops.flash_attention = record
    try:
        with spatial.spatial(plan):
            mine = spatial.narrow(x.view(1, -1, 16, 32), 1, group,
                                  plan.blocks(16))
            y = attn(mine.reshape(1, -1, 32), cols=16)
    finally:
        attention_ops.flash_attention = real
    y = spatial.gather(y.view(1, -1, 16, 32), 1, group, plan.blocks(16))
    return y.reshape(x.shape), routed


def _shares(mesh) -> dict:
    """The rows each tower call and prior call see on this rank, and the
    (frames, tokens) of each temporal attention of the UNet and the prior,
    in one `generate`."""
    pipe = _pipeline(mesh)
    seen = {k: [] for k in ("text_s1", "text_s2", "vision", "prior",
                            "unet_b", "prior_b")}
    for name in ("text_s1", "text_s2", "vision"):
        getattr(pipe, name).register_forward_pre_hook(
            lambda m, a, name=name: seen[name].append(a[0].shape[0]))
    pipe.prior.register_forward_pre_hook(
        lambda m, a: seen["prior"].append(a[0].shape[1]))
    for tower, key in ((pipe.unet, "unet_b"), (pipe.prior, "prior_b")):
        for m in tower.modules():
            if isinstance(m, Attention) and m.frame_axis:
                m.register_forward_pre_hook(
                    lambda m, a, key=key: seen[key].append(
                        tuple(a[0].shape[1:3])))
    pipe.generate(_story(pipe.configs, 1), noise=_noise(pipe, 11))
    return seen


def _rank_jobs(world: int, frame: int, rank: int, root: str) -> dict:
    out = {}
    mesh = sharding.inference_mesh(frame)
    out["mesh"] = tuple(mesh[:6])
    with torch.no_grad():
        out["story"] = _story_jobs(mesh)
        if (world, frame) == (JAX_WORLD, 1):
            pipe = _pipeline(mesh)
            out["jax"] = pipe.generate(tiny_inputs(pipe.configs, 0),
                                       noise=_jax_noise(pipe))
            out["px36"] = pipe.generate(_story(pipe.configs, 1, pixels=36),
                                        noise=_noise(pipe, 11, pixels=36))
            try:
                pipe.generate(_story(pipe.configs, 1, pixels=34),
                              noise=_noise(pipe, 11, pixels=34))
            except ValueError as e:
                out["rows_error"] = str(e)
        if (world, frame) in JAX_MESHES:
            pipe = _pipeline(mesh)
            noise = torch.load(os.path.join(root, "jax_key_noise.pt"))
            out["jax_sharded"] = pipe.generate(tiny_inputs(pipe.configs, 0),
                                               noise=StoryNoise(*noise))
        if (world, frame) in SHARE_MESHES:
            out["shares"] = _shares(mesh)
        if (world, frame) in INT8_MESHES:
            out["int8"] = _int8_jobs(mesh)
        if frame == 1 and world in MODULE_WORLDS:
            out["modules"] = {
                name: _split_module(fn, x, args, split, mesh.all)
                for name, (fn, x, args, split) in _module_cases().items()}
        if world == 2:
            out["routed"] = {q: _routed_split(mesh.all, q)
                             for q in (256, 128)}
    if world == 2:
        pevaluate.main(CLI_ARGS + ["--shard-story", "--output-dir",
                                   os.path.join(root, f"cli{rank}")])
    return out


def _rank_main(index: int, root: str) -> None:
    """Pool process `index`: rank `index` of each mesh it belongs to, in
    turn, each a process group of its own."""
    torch.set_num_threads(1)
    for world, frame in MESHES:
        if index >= world:
            continue
        tag = _mesh_id((world, frame))
        distributed.maybe_initialize(
            "cpu", init_method=f"file://{os.path.join(root, f'store{tag}')}",
            world_size=world, rank=index)
        try:
            torch.save(_rank_jobs(world, frame, index, root),
                       os.path.join(root, f"w{tag}_r{index}.pt"))
        finally:
            distributed.shutdown()


class Pool:
    """The pool's processes, joined (once) when a test reads them."""

    def __init__(self, root):
        self.root = str(root)
        torch.save(tuple(_jax_key_noise()),
                   os.path.join(self.root, "jax_key_noise.pt"))
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=_rank_main, args=(i, self.root))
                      for i in range(POOL)]
        for p in self.procs:
            p.start()
        self._joined = False
        self._loaded = {}

    def result(self, mesh, rank: int = 0) -> dict:
        if not isinstance(mesh, tuple):
            mesh = (mesh, 1)
        if not self._joined:
            for p in self.procs:
                p.join(JOIN_S)
            self._joined = True
        alive = [p.pid for p in self.procs if p.is_alive()]
        for p in self.procs:
            if p.is_alive():
                p.kill()
        assert not alive, f"ranks {alive} did not finish in {JOIN_S} s"
        codes = [p.exitcode for p in self.procs]
        assert codes == [0] * POOL, f"pool exit codes {codes}"
        if (mesh, rank) not in self._loaded:
            self._loaded[mesh, rank] = torch.load(
                os.path.join(self.root, f"w{_mesh_id(mesh)}_r{rank}.pt"),
                weights_only=False)
        return self._loaded[mesh, rank]


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    pool = Pool(tmp_path_factory.mktemp("pool"))
    yield pool
    for p in pool.procs:
        if p.is_alive():
            p.kill()


@pytest.fixture(scope="module")
def one_process():
    """The one-process port's outputs of `_story_jobs` (no mesh)."""
    with torch.no_grad():
        return _story_jobs(None)


@pytest.fixture(scope="module")
def one_process_int8():
    """The one-process port's outputs of `_int8_jobs` (no mesh)."""
    with torch.no_grad():
        return _int8_jobs(None)


@pytest.fixture(scope="module")
def jax_story(tmp_path_factory):
    """tests/test_torch_pipeline.py's `build_story` tuple, once."""
    from tests import test_torch_pipeline as tp

    return tp.build_story(str(tmp_path_factory.mktemp("selftest")
                              / "ref.npz"))


def _close(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, **TOL)


# ---- here, in this process --------------------------------------------------

@pytest.mark.parametrize("n, frame", [
    pytest.param(n, f, id=_mesh_id((n, f)))
    for f in range(1, 5) for n in range(1, 9)])
def test_mesh_shape_matches_jax_inference_mesh(n, frame):
    """At every 'frame' axis 1-4, the fallback to 1 included."""
    import jax

    from rcdms_tpu.train.sharding import inference_mesh as jax_mesh

    want = jax_mesh(jax.devices()[:n], frame=frame).shape
    assert sharding.mesh_shape(n, frame) == (
        want["cfg"], want["frame"], want["space"])
    if frame == 1:
        assert sharding.mesh_shape(n) == sharding.mesh_shape(n, 1)
        assert sharding.mesh_shape(n)[::2] == {
            1: (1, 1), 2: (2, 1), 3: (1, 3), 4: (2, 2), 5: (1, 5),
            6: (2, 3), 7: (1, 7), 8: (2, 4)}[n]


def _tiles(table, rows: int, granule: int) -> None:
    """Blocks in rank order tile `rows` rows, each starting on a multiple
    of `granule`, the empty ones last."""
    at = 0
    for o, n in table:
        assert o == at and n >= 0 and (o % granule == 0 or n == 0)
        at += n
    assert at == rows
    sizes = [n for _, n in table]
    assert sizes == sorted(sizes, reverse=True)


@pytest.mark.parametrize("frame", (1, 2))
@pytest.mark.parametrize("world", range(1, 9))
def test_full_width_plan_splits_at_every_world(world, frame):
    """The full-width story's splits (64 latent rows at the UNet's 4
    levels, 512 px at the VAE's 4, 5 frames) at every world, no model
    built: `check_rows` accepts them, and every plan's blocks tile the
    rows at every level, each starting on an even row at every level a
    stride-2 conv halves."""
    cfg, frame, space = sharding.mesh_shape(world, frame)
    unet = len(StoryUNetConfig().block_channels)
    vae = len(VAEConfig().block_channels)
    latent = 512 >> (vae - 1)
    everyone = spatial.RowGroup(None, world, 0)
    rows = spatial.RowGroup(None, space, 0)
    spatial.check_rows(latent, unet, rows, "the UNet's latent rows")
    plans = (spatial.RowPlan(rows, latent, latent, unet),
             spatial.RowPlan(everyone, 512, 512, vae),
             spatial.RowPlan(everyone, latent, latent, 1, vae - 1))
    for plan in plans:
        for level in range(-plan.up, plan.levels):
            cols = (plan.cols >> level if level >= 0
                    else plan.cols << -level)
            total = plan.rows >> level if level >= 0 else plan.rows << -level
            halved = plan.levels - 1 - max(level, 0)
            _tiles(plan.blocks(cols), total, 1 << halved)
    for n, ranks in ((5, frame), (5, world), (5, frame * space)):
        _tiles(spatial.blocks(n, ranks), n, 1)


def test_unsplit_rows_raise():
    """`check_rows` raises only where a UNet's rows do not halve at each
    stride-2 conv (the JAX package fails there too); rows that split
    unevenly over the ranks run (`RowPlan`)."""
    four = spatial.RowGroup(None, 4, 0)
    for rows, levels in ((64, 4), (20, 1), (36, 2), (24, 3), (30, 1)):
        spatial.check_rows(rows, levels, four, "rows")
        plan = spatial.RowPlan(four, rows, 8, levels)
        _tiles(plan.blocks(8), rows, 1 << (levels - 1))
    for rows, levels in ((36, 4), (20, 4), (17, 2)):
        with pytest.raises(ValueError, match="do not halve"):
            spatial.check_rows(rows, levels, four, "rows")


def test_router_takes_the_whole_query_count(monkeypatch):
    routed = []
    monkeypatch.setattr(attention_ops, "flash_attention",
                        lambda *a, **kw: routed.append(a) or a[0])
    q, kv = torch.zeros(1, 128, 32), torch.zeros(1, 256, 32)
    attention_ops.multihead_attention(q, kv, kv, 2, row_sum="rounded",
                                      queries=256)
    assert len(routed) == 1
    attention_ops.multihead_attention(q, kv, kv, 2, row_sum="rounded")
    assert len(routed) == 1


def test_one_rank_mesh_equals_no_mesh_bit_for_bit(tmp_path):
    assert not distributed.active()
    plain = _pipeline()
    configs = plain.configs
    with torch.no_grad():
        want = plain.generate(_story(configs, 1), noise=_noise(plain, 11))
        distributed.maybe_initialize(
            "cpu", init_method=f"file://{tmp_path / 'store'}",
            world_size=1, rank=0)
        try:
            mesh = sharding.inference_mesh()
            assert tuple(mesh[:6]) == (1, 1, 1, 0, 0, 0)
            meshed = _pipeline(mesh)
            sharding.check_replicated(meshed, mesh.all)
            got = meshed.generate(_story(configs, 1),
                                  noise=_noise(meshed, 11))
        finally:
            distributed.shutdown()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ---- the pool --------------------------------------------------------------

@pytest.mark.parametrize("mesh", JAX_MESHES, ids=_mesh_id)
def test_sharded_story_equals_the_jax_sharded_story(pool, jax_story, mesh):
    """The port's story on a mesh against the JAX package's on the same
    ('cfg', 'frame', 'space') mesh of CPU devices, on the same weights,
    inputs and draws (the JAX generate's from PRNGKey(1))."""
    import dataclasses

    import jax

    from rcdms_tpu.train.sharding import inference_mesh as jax_mesh

    from tests import test_torch_pipeline as tp

    _, inputs, params, jpipe, _ = jax_story
    world, frame = mesh
    jmesh = jax_mesh(jax.devices()[:world], frame=frame)
    assert tuple(jmesh.shape.values()) == sharding.mesh_shape(world, frame)
    sharded = dataclasses.replace(
        jpipe, mesh=jmesh,
        prior_sampler=dataclasses.replace(jpipe.prior_sampler, mesh=jmesh),
        story_sampler=dataclasses.replace(jpipe.story_sampler, mesh=jmesh))
    jinputs = tp.jpipeline.StoryInputs(*(jax.numpy.asarray(t.numpy())
                                         for t in inputs))
    frames, embeds = jax.jit(sharded.generate)(params, jinputs,
                                               jax.random.PRNGKey(1))
    got_frames, got_embeds = pool.result(mesh)["jax_sharded"]
    np.testing.assert_allclose(got_embeds.numpy(), np.asarray(embeds),
                               **tp.SAMPLER_TOL)
    np.testing.assert_allclose(got_frames.numpy(), np.asarray(frames),
                               **tp.FRAME_TOL)


@pytest.mark.parametrize("mesh", MESHES, ids=_mesh_id)
@pytest.mark.parametrize("job", JOBS)
def test_sharded_story_equals_one_process(pool, one_process, mesh, job):
    got = pool.result(mesh)
    cfg, frame, space = sharding.mesh_shape(*mesh)
    assert got["mesh"][:3] == (cfg, frame, space)
    _close(got["story"][job], one_process[job])


@pytest.mark.parametrize("mesh", INT8_MESHES, ids=_mesh_id)
@pytest.mark.parametrize("cfg", ("sequential", "batched"))
def test_int8_scale_is_the_whole_tensors(pool, one_process_int8, mesh, cfg):
    """Each int8 conv's activation scale is the MAX over the ranks that
    hold its whole input in one process (its rows and frames, and both
    CFG branches where one process batches them): every rank of a branch
    takes the same scales, and in the first step they are one process's
    within INT8_SCALE_RTOL. (The int8 story itself is not held to TOL: a
    value that rounds to the other int8 neighbour changes it by up to
    0.054 in one process alone, for init noise changed by 1e-7 of
    itself; a scale of the rank's rows or frames alone is 16-26% off.)"""
    branches = {}
    for r in range(mesh[0]):
        got = pool.result(mesh, r)
        c = got["mesh"][3]
        if c in branches:
            assert torch.equal(got["int8"][cfg], branches[c]), r
        branches.setdefault(c, got["int8"][cfg])
    want = one_process_int8[cfg]
    calls = len(branches[0]) // STEPS  # int8 convs in one UNet call
    first = torch.stack([branches[c][:calls] for c in sorted(branches)])
    if cfg == "sequential":  # one process: uncond then cond, each step
        expected = want[:2 * calls].view(2, calls)
    else:  # one process: both branches in one call
        expected = want[:calls].expand(2, calls)
    torch.testing.assert_close(first, expected, rtol=INT8_SCALE_RTOL,
                               atol=0)


@pytest.mark.parametrize("mesh", MESHES, ids=_mesh_id)
def test_every_rank_returns_the_whole_story(pool, mesh):
    want = pool.result(mesh, 0)["story"]
    for r in range(1, mesh[0]):
        got = pool.result(mesh, r)["story"]
        for job in JOBS:
            for g, w in zip(got[job], want[job]):
                assert torch.equal(g, w), (r, job)


@pytest.mark.parametrize("mesh", SHARE_MESHES, ids=_mesh_id)
def test_each_rank_runs_its_share(pool, mesh):
    """Each rank's towers see its block of the 5 images or captions (none
    on some), its prior its block of the frames over its CFG branch's
    ranks, and every temporal attention every frame of its block of
    tokens."""
    world, _ = mesh
    cfg, frame, space = sharding.mesh_shape(*mesh)
    towers = spatial.blocks(5, world)
    prior = spatial.blocks(5, frame * space)
    seq = tiny_configs().prior.seq_len  # the prior's tokens a frame
    unet_tokens = {}
    for r in range(world):
        got = pool.result(mesh, r)
        c, fr, s = got["mesh"][3:]
        seen = got["shares"]
        for name in ("text_s1", "text_s2", "vision"):
            assert seen[name] and set(seen[name]) == {towers[r][1]}, name
        assert set(seen["prior"]) == {prior[fr * space + s][1]}
        tokens = spatial.blocks(seq, frame * space)[fr * space + s][1]
        assert set(seen["prior_b"]) == {(5, tokens)}
        assert {f for f, _ in seen["unet_b"]} == {5}
        unet_tokens.setdefault((c, s), []).append(seen["unet_b"])
    # a frame group's ranks split each map's tokens among them
    rows = spatial.blocks(16, space, 2)
    for (c, s), per_rank in unet_tokens.items():
        assert len(per_rank) == frame
        first = sum(calls[0][1] for calls in per_rank)
        assert first == rows[s][1] * 16


def test_world4_equals_the_jax_story(pool, jax_story):
    """The world-4 frames against the JAX package's unsharded story on the
    same weights and noise (tests/test_torch_pipeline.py)."""
    from tests import test_torch_pipeline as tp

    port, inputs, params, jpipe, a = jax_story
    mine = _pipeline()
    want_sd = port.state_dict()
    assert all(torch.equal(t, want_sd[k])
               for k, t in mine.state_dict().items())
    for g, w in zip(_jax_noise(mine), tp.self_test_noise(port, a)):
        assert (g is w is None) or torch.equal(g, w)
    frames, embeds = pool.result(JAX_WORLD)["jax"]
    np.testing.assert_allclose(embeds.numpy(), a["reference_prior_embeds"],
                               **tp.SAMPLER_TOL)
    np.testing.assert_allclose(frames.numpy(),
                               tp.jax_frames(port, params, jpipe, a),
                               **tp.FRAME_TOL)


@pytest.mark.parametrize("world", MODULE_WORLDS)
@pytest.mark.parametrize("name", list(_module_cases()))
def test_split_module_equals_whole(pool, world, name):
    fn, x, args, _ = _module_cases()[name]
    with torch.no_grad():
        want = fn(x, *args)
    got = pool.result(world)["modules"][name]
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, **TOL)


def test_split_256_query_site_takes_kernel_a(pool):
    """Split two ways, a 256-query site reaches `flash_attention` with its
    128 local queries on each rank (a 128-query site, 64 local, does not),
    and both equal the whole site."""
    routed = {r: pool.result(2, r)["routed"] for r in range(2)}
    for r in range(2):
        assert routed[r][256][1] == [128]
        assert routed[r][128][1] == []
    for queries in (256, 128):
        attn, x = _attention_site(queries)
        with torch.no_grad():
            torch.testing.assert_close(routed[0][queries][0], attn(x),
                                       **TOL)


def test_rows_that_do_not_split_raise(pool):
    """At world 4 a 36 px story, whose rows split unevenly at every level,
    equals one process; a 34 px one, whose 17 latent rows no UNet halves,
    raises with the world size."""
    got = pool.result(JAX_WORLD)
    assert "17 rows do not halve" in got["rows_error"]
    assert "world size 4" in got["rows_error"]
    pipe = _pipeline()
    with torch.no_grad():
        want = pipe.generate(_story(pipe.configs, 1, pixels=36),
                             noise=_noise(pipe, 11, pixels=36))
    _close(got["px36"], want)


def test_evaluate_shard_story_writes_the_one_process_run(pool, tmp_path):
    pool.result(2)
    one = tmp_path / "one"
    pevaluate.main(CLI_ARGS + ["--output-dir", str(one)])
    sharded = os.path.join(pool.root, "cli0")
    assert not os.path.exists(os.path.join(pool.root, "cli1"))
    assert sorted(os.listdir(sharded)) == sorted(os.listdir(one))

    def metrics(d):
        with open(os.path.join(d, "metrics_0.jsonl")) as fh:
            return [json.loads(line) for line in fh]

    got, want = metrics(sharded), metrics(one)
    assert [m.keys() for m in got] == [m.keys() for m in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(list(g.values()), list(w.values()),
                                   rtol=1e-4)
    pngs = [n for n in os.listdir(one) if n.endswith(".png")]
    assert pngs
    for name in pngs:
        images = []
        for d in (sharded, one):
            with open(os.path.join(d, name), "rb") as fh:
                images.append(decode_png(fh.read()).astype(int))
        assert np.abs(images[0] - images[1]).max() <= 1, name
