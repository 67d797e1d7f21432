"""Checkpoint ingest of the port (rcdms_tpu_torch/io/convert.py and the
loaders of rcdms_tpu_torch/cli/common.py) against the JAX package's, on
the same synthetic files.

Trained reference blobs: a stage-1 blob (bare .pt, "module." keys) and a
stage-2 DeepSpeed directory (`latest` tag, unet. / seen_module. /
unseen_module. keys) load into both packages, and every tensor the port
holds equals the JAX tree's, taken to state-dict names through
rcdms_tpu_torch/io/bridge.py; an ambiguous directory, a partial blob and
keys the module lacks raise in both.

Pretrained starts: synthetic HF / diffusers-layout state dicts (Kandinsky
prior blocks, a CLIP text tower whose tables are resized, both VAE
attention namings, SD's 1x1-conv proj_in) go to both packages' builders:
the loaded tensors agree bit for bit, the keys left fresh agree, and with
the fresh keys set alike the towers' fp32 outputs agree within 1e-5."""

import argparse
import os
import re

import numpy as np
import pytest
import torch

from rcdms_tpu import configs as jconfigs
from rcdms_tpu.cli import common as jcommon
from rcdms_tpu.io import convert as jconvert
from rcdms_tpu.models import clip as jclip
from rcdms_tpu.models import prior as jprior
from rcdms_tpu.models import unet3d as junet
from rcdms_tpu.models import vae as jvae
from rcdms_tpu_torch.cli import common as pcommon
from rcdms_tpu_torch.io import bridge
from rcdms_tpu_torch.io import convert as pconvert
from rcdms_tpu_torch.models import clip as tclip
from rcdms_tpu_torch.models import prior as tprior
from rcdms_tpu_torch.models import unet3d as tunet
from rcdms_tpu_torch.models import vae as tvae
from tests.test_torch_configs import (  # noqa: F401 (autouse fixture)
    one_torch_thread,
    port_config,
)
from tests.test_torch_models import _apply, _weights, _x

TOL = dict(atol=1e-5, rtol=1e-5)


def _save(sd, path, module=False):
    """A numpy state dict as a torch file; `module`: wrapped as DeepSpeed's
    {"module": ...}."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v))
               for k, v in sd.items()}
    torch.save({"module": tensors} if module else tensors, path)


def _np_sd(module):
    return {k: v.detach().float().numpy() for k, v in
            module.state_dict().items()}


def _assert_sd_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k], np.float32),
                                      err_msg=k)


# ---------------------------------------------------------------------------
# trained reference blobs
# ---------------------------------------------------------------------------


def _prior_blob(seed=0):
    jcfg = jconfigs.PriorConfig.tiny()
    cfg = port_config(jcfg)
    return jcfg, cfg, _weights(tprior.FramePrior(cfg), seed)


def _unet_fusion_blob(seed=1):
    jucfg = jconfigs.StoryUNetConfig.tiny()
    jfcfg = jconfigs.FusionConfig.tiny(
        hidden_dim=jucfg.cross_attention_dim,
        text_dim=jucfg.cross_attention_dim)
    ucfg, fcfg = port_config(jucfg), port_config(jfcfg)
    from rcdms_tpu_torch.models.fusion import FusionModule

    sd = {f"unet.{k}": v
          for k, v in _weights(tunet.StoryUNet(ucfg), seed).items()}
    sd.update(_weights(FusionModule(fcfg), seed + 1))
    return (jucfg, jfcfg), (ucfg, fcfg), sd


def test_stage1_bare_blob_loads_like_jax(tmp_path):
    jcfg, cfg, sd = _prior_blob()
    path = str(tmp_path / "prior.pt")
    torch.save({"module": {f"module.{k}": torch.from_numpy(v)
                           for k, v in sd.items()},
                "epoch": 3, "last_global_step": 1234}, path)
    _, jfresh = jcommon.build_prior(jcfg, None)
    jloaded = jcommon.load_rcdms_stage1(path, jcfg, jfresh)
    prior = pcommon.build_prior(cfg, None, device="cpu", seed=5)
    assert pcommon.load_rcdms_stage1(path, prior) is prior
    _assert_sd_equal(_np_sd(prior), bridge.prior_state_dict(jloaded, cfg))
    _assert_sd_equal(_np_sd(prior), sd)


def test_stage2_deepspeed_dir_with_latest_tag_loads_like_jax(tmp_path):
    (jucfg, jfcfg), (ucfg, fcfg), sd = _unet_fusion_blob()
    # an older step with other weights: only the tag makes this unambiguous
    _, _, stale = _unet_fusion_blob(seed=7)
    for step, blob in (("global_step3", stale), ("global_step7", sd)):
        _save(blob, str(tmp_path / step / "mp_rank_00_model_states.pt"),
              module=True)
    (tmp_path / "latest").write_text("global_step7\n")

    _, ufresh = jcommon.build_unet(jucfg, None)
    _, ffresh = jcommon.build_fusion(jfcfg)
    juloaded, jfloaded = jcommon.load_rcdms_stage2(str(tmp_path), jucfg,
                                                   ufresh, ffresh)
    unet = pcommon.build_unet(ucfg, None, device="cpu", seed=5)
    fusion = pcommon.build_fusion(fcfg, device="cpu", seed=5)
    pcommon.load_rcdms_stage2(str(tmp_path), unet, fusion)
    _assert_sd_equal(_np_sd(unet), bridge.unet_state_dict(juloaded, ucfg))
    _assert_sd_equal(_np_sd(fusion), bridge.fusion_state_dict(jfloaded))
    _assert_sd_equal(_np_sd(unet), {k[5:]: v for k, v in sd.items()
                                    if k.startswith("unet.")})


def test_ambiguous_and_empty_directories_raise_in_both(tmp_path):
    _, _, sd = _prior_blob()
    for step in ("step1", "step2"):
        _save(sd, str(tmp_path / "ckpt" / step / "mp_rank_00_model_states.pt"))
    (tmp_path / "empty").mkdir()
    for load in (jcommon.load_rcdms_blob, pcommon.load_rcdms_blob):
        with pytest.raises(ValueError, match="ambiguous"):
            load(str(tmp_path / "ckpt"))
        with pytest.raises(FileNotFoundError):
            load(str(tmp_path / "empty"))


def test_trusted_pickle_fallback_warns_in_both(tmp_path):
    _, _, sd = _prior_blob()
    path = str(tmp_path / "mp_rank_00_model_states.pt")
    torch.save({"module": {k: torch.from_numpy(v) for k, v in sd.items()},
                "args": argparse.Namespace(lr=1e-5)}, path)
    for load in (jcommon.load_rcdms_blob, pcommon.load_rcdms_blob):
        with pytest.warns(UserWarning, match="TRUSTED"):
            parts = load(path)
        assert set(parts["rest"]) == set(sd)


def test_partial_blobs_are_rejected_by_both(tmp_path):
    jcfg, cfg, sd = _prior_blob()
    sd.pop("prd_embedding")
    path = str(tmp_path / "prior.pt")
    _save(sd, path)
    _, jfresh = jcommon.build_prior(jcfg, None)
    with pytest.raises(ValueError, match="fresh"):
        jcommon.load_rcdms_stage1(path, jcfg, jfresh)
    prior = pcommon.build_prior(cfg, None, device="cpu")
    before = _np_sd(prior)
    with pytest.raises(ValueError, match="fresh"):
        pcommon.load_rcdms_stage1(path, prior)
    _assert_sd_equal(_np_sd(prior), before)  # nothing was loaded

    (jucfg, jfcfg), (ucfg, fcfg), sd2 = _unet_fusion_blob()
    sd2 = {k: v for k, v in sd2.items()
           if not k.startswith("unet.down_blocks.0.motion_modules.0.")}
    path2 = str(tmp_path / "unet.pt")
    _save(sd2, path2)
    _, ufresh = jcommon.build_unet(jucfg, None)
    _, ffresh = jcommon.build_fusion(jfcfg)
    with pytest.raises(ValueError, match="fresh"):
        jcommon.load_rcdms_stage2(path2, jucfg, ufresh, ffresh)
    with pytest.raises(ValueError, match="fresh"):
        pcommon.load_rcdms_stage2(path2, pcommon.build_unet(
            ucfg, None, device="cpu"), pcommon.build_fusion(
            fcfg, device="cpu"))


def test_unknown_and_misshapen_keys_raise_as_merge_params_does():
    jcfg, cfg, sd = _prior_blob()
    _, jfresh = jcommon.build_prior(jcfg, None)
    prior = pcommon.build_prior(cfg, None, device="cpu")
    # a converted key the model lacks: KeyError in both
    with pytest.raises(KeyError):
        jconvert.merge_params(jfresh["params"], {"no_such_layer": {
            "kernel": np.zeros((16, 16), np.float32)}})
    with pytest.raises(KeyError):
        pconvert.merge_into(prior, {"no_such_layer.weight":
                                    torch.zeros(16, 16)})
    # a converted key of another shape: ValueError in both, through the
    # stage-1 loaders
    bad = dict(sd, **{"proj_in.weight": np.zeros((16, 8), np.float32)})
    jbad = jconvert.convert_rcdms_prior(bad, jcfg)
    with pytest.raises(ValueError, match="shape"):
        jconvert.merge_params(jfresh["params"], jbad)
    with pytest.raises(ValueError, match="shape"):
        pconvert.merge_into(prior, pconvert.convert_rcdms_prior(
            {k: torch.from_numpy(v) for k, v in bad.items()}, cfg))
    # keys the converters do not read are dropped by both (Kandinsky's
    # clip_mean / clip_std)
    extra = {k: torch.from_numpy(v) for k, v in sd.items()}
    extra["clip_mean"] = torch.zeros(1, 16)
    assert "clip_mean" not in pconvert.convert_rcdms_prior(extra, cfg)


# ---------------------------------------------------------------------------
# pretrained starts
# ---------------------------------------------------------------------------


def _fresh_keys(loaded, init):
    """State-dict keys a JAX builder left at its init (the synthetic
    checkpoint's values are random, so no loaded key equals its init)."""
    return {k for k in loaded if np.array_equal(loaded[k], init[k])}


def _match_fresh(module, fresh, want):
    """Set the port's fresh keys to the JAX tower's values, so the two
    towers hold the same weights."""
    module.load_state_dict({k: torch.tensor(np.asarray(want[k], np.float32))
                            for k in fresh}, strict=False)


def test_kandinsky_prior_blocks_interleave_like_jax(tmp_path):
    jcfg = jconfigs.PriorConfig.tiny()
    cfg = port_config(jcfg)
    ref = _weights(tprior.FramePrior(cfg), 2)
    # the Kandinsky layout: attention block i at transformer_blocks.{i}, no
    # temporal modules or extra conditioning heads, a 77-token positional
    # table, and the diffusers prior's clip statistics
    sd = {}
    for k, v in ref.items():
        m = re.fullmatch(r"transformer_blocks\.(\d+)\.(.*)", k)
        if m:
            if int(m.group(1)) % 2 == 0:
                sd[f"transformer_blocks.{int(m.group(1)) // 2}."
                   f"{m.group(2)}"] = v
        elif not k.startswith(("embedding_proj1", "embedding_proj2",
                               "positional_embedding")):
            sd[k] = v
    sd["positional_embedding"] = _x(3, 1, 77, cfg.inner_dim)
    sd["clip_mean"], sd["clip_std"] = _x(4, 1, 16), _x(5, 1, 16)
    _save(sd, str(tmp_path / "diffusion_pytorch_model.bin"))

    _, jp = jcommon.build_prior(jcfg, str(tmp_path))
    _, jinit = jcommon.build_prior(jcfg, None)
    want = bridge.prior_state_dict(jp, cfg)
    prior = pcommon.build_prior(cfg, str(tmp_path), device="cpu", seed=3)
    got = _np_sd(prior)
    fresh = _fresh_keys(want, bridge.prior_state_dict(jinit, cfg))
    assert fresh == set(pconvert.fresh_keys(prior, {
        k: v for k, v in prior.state_dict().items() if k not in fresh}))
    assert any(k.startswith("transformer_blocks.1.") for k in fresh)
    assert "positional_embedding" in fresh and "embedding_proj1.weight" in \
        fresh
    for k in set(want) - fresh:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for i in range(cfg.num_layers):  # block i landed in slot 2i
        np.testing.assert_array_equal(
            got[f"transformer_blocks.{2 * i}.attn1.to_q.weight"],
            sd[f"transformer_blocks.{i}.attn1.to_q.weight"])

    _match_fresh(prior, fresh, want)
    b, f, d, t = 2, 5, 16, 7
    mask = np.ones((b, f, t), bool)
    mask[0, :, 4:] = False
    args = (_x(9, b, f, d), np.full((b, f), 700, np.int32), _x(10, b, f, d),
            _x(11, b, f, t, d), _x(12, b, f, d), _x(13, b, f, d), mask)
    out = _apply(jprior.FramePrior(jcfg), jp["params"], *args)
    with torch.no_grad():
        mine = prior(*map(torch.from_numpy, args))
    np.testing.assert_allclose(mine.numpy(), np.asarray(out), **TOL)


@pytest.mark.parametrize("prefix", ["text_model.", ""])
def test_clip_text_tables_resize_like_jax(tmp_path, prefix):
    """A 40-token vocab and 5 positions grow to the config's 64 and 7, by
    the same seeded draws; HF's position_ids buffer is dropped."""
    jcfg = jconfigs.CLIPTextConfig.tiny(hidden_act="gelu")
    cfg = port_config(jcfg)
    small = tclip.CLIPTextEncoder(port_config(jconfigs.CLIPTextConfig.tiny(
        vocab_size=40, max_positions=5)))
    sd = {(k if k.startswith("text_projection") else
           prefix + k[len("text_model."):]): v
          for k, v in _weights(small, 4).items()}
    sd[f"{prefix}embeddings.position_ids"] = np.arange(5)[None]
    _save(sd, str(tmp_path / "pytorch_model.bin"))

    _, jp = jcommon.build_text_encoder(jcfg, str(tmp_path))
    enc = pcommon.build_text_encoder(cfg, str(tmp_path), device="cpu")
    _assert_sd_equal(_np_sd(enc), bridge.clip_text_state_dict(jp))
    table = enc.text_model.embeddings.token_embedding.weight
    assert table.shape == (64, 16)
    np.testing.assert_array_equal(
        table[:40].numpy(), sd[f"{prefix}embeddings.token_embedding.weight"])

    ids = np.random.default_rng(7).integers(0, 64, (3, 7)).astype(np.int32)
    ids[:, 5] = cfg.eos_token_id
    h, e = _apply(jclip.CLIPTextEncoder(jcfg), jp["params"], ids)
    with torch.no_grad():
        th, te = enc(torch.from_numpy(ids).long())
    np.testing.assert_allclose(th.numpy(), np.asarray(h), **TOL)
    np.testing.assert_allclose(te.numpy(), np.asarray(e), **TOL)


def test_safetensors_sibling_is_preferred(tmp_path):
    safetensors = pytest.importorskip("safetensors.torch")
    jcfg = jconfigs.CLIPTextConfig.tiny()
    cfg = port_config(jcfg)
    sd = _weights(tclip.CLIPTextEncoder(cfg), 6)
    # the .bin holds other weights: the .safetensors file must win
    _save(_weights(tclip.CLIPTextEncoder(cfg), 7),
          str(tmp_path / "pytorch_model.bin"))
    safetensors.save_file({k: torch.from_numpy(v) for k, v in sd.items()},
                          str(tmp_path / "model.safetensors"))
    _, jp = jcommon.build_text_encoder(jcfg, str(tmp_path))
    enc = pcommon.build_text_encoder(cfg, str(tmp_path), device="cpu")
    _assert_sd_equal(_np_sd(enc), bridge.clip_text_state_dict(jp))
    np.testing.assert_array_equal(
        enc.text_model.encoder.layers[0].mlp.fc1.weight.numpy(),
        sd["text_model.encoder.layers.0.mlp.fc1.weight"])


@pytest.mark.parametrize("spelling", ["pre_layrnorm", "pre_layernorm"])
def test_clip_vision_loads_like_jax(tmp_path, spelling):
    jcfg = jconfigs.CLIPVisionConfig.tiny()
    cfg = port_config(jcfg)
    sd = {k.replace("pre_layrnorm", spelling): v for k, v in
          _weights(tclip.CLIPVisionEncoder(cfg), 5).items()}
    sd["vision_model.embeddings.position_ids"] = np.arange(5)[None]
    _save(sd, str(tmp_path / "pytorch_model.bin"))
    _, jp = jcommon.build_vision_encoder(jcfg, str(tmp_path))
    enc = pcommon.build_vision_encoder(cfg, str(tmp_path), device="cpu")
    _assert_sd_equal(_np_sd(enc), bridge.clip_vision_state_dict(jp))
    px = _x(8, 2, 28, 28, 3)
    h, e = _apply(jclip.CLIPVisionEncoder(jcfg), jp["params"], px)
    with torch.no_grad():
        th, te = enc(torch.from_numpy(px))
    np.testing.assert_allclose(th.numpy(), np.asarray(h), **TOL)
    np.testing.assert_allclose(te.numpy(), np.asarray(e), **TOL)


_OLD_VAE = {"to_q": "query", "to_k": "key", "to_v": "value",
            "to_out.0": "proj_attn"}


@pytest.mark.parametrize("naming", ["to_q", "query"])
def test_sd_vae_attention_namings_load_like_jax(tmp_path, naming):
    """diffusers' current attention names (Linear weights), and the old
    ones with 1x1-conv weights and LDM's nin_shortcut."""
    jcfg = jconfigs.VAEConfig.tiny()
    cfg = port_config(jcfg)
    sd = _weights(tvae.VAE(cfg), 6)
    if naming == "query":
        old = {}
        for k, v in sd.items():
            m = re.fullmatch(r"(.*\.attentions\.0)\.(to_q|to_k|to_v|to_out\.0)"
                             r"\.(weight|bias)", k)
            if m:
                k = f"{m.group(1)}.{_OLD_VAE[m.group(2)]}.{m.group(3)}"
                v = v[:, :, None, None] if v.ndim == 2 else v
            old[k.replace(".conv_shortcut.", ".nin_shortcut.")] = v
        assert any(".nin_shortcut." in k for k in old)
        sd = old
    _save(sd, str(tmp_path / "diffusion_pytorch_model.bin"))
    _, jp = jcommon.build_vae(jcfg, str(tmp_path))
    vae = pcommon.build_vae(cfg, str(tmp_path), device="cpu", seed=9)
    _assert_sd_equal(_np_sd(vae), bridge.vae_state_dict(jp, cfg))

    x, z = _x(5, 2, 32, 32, 3), _x(6, 2, 16, 16, 4)
    jm = jvae.VAE(jcfg)
    mean, logvar = _apply(jm, jp["params"], x, method=jvae.VAE.encode)
    dec = _apply(jm, jp["params"], z, method=jvae.VAE.decode)
    with torch.no_grad():
        tmean, tlogvar = vae.encode(torch.from_numpy(x))
        tdec = vae.decode(torch.from_numpy(z))
    for a, b in ((tmean, mean), (tlogvar, logvar), (tdec, dec)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_sd_unet_loads_1x1_projections_like_jax(tmp_path):
    """SD's spatial transformers hold proj_in / proj_out as 1x1 convs; its
    4-channel conv_in is not read, and the temporal modules stay fresh."""
    jcfg = jconfigs.StoryUNetConfig.tiny()
    cfg = port_config(jcfg)
    sd = {}
    for k, v in _weights(tunet.StoryUNet(cfg), 8).items():
        if ".motion_modules." in k or k.startswith("conv_in."):
            continue
        if re.search(r"attentions\.\d+\.proj_(in|out)\.weight$", k):
            v = v[:, :, None, None]
        sd[k] = v
    sd["conv_in.weight"] = _x(1, 32, 4, 3, 3)  # SD's 4-channel input
    sd["conv_in.bias"] = _x(2, 32)
    assert any(v.ndim == 4 and v.shape[2:] == (1, 1) for v in sd.values())
    _save(sd, str(tmp_path / "diffusion_pytorch_model.bin"))

    _, jp = jcommon.build_unet(jcfg, str(tmp_path))
    _, jinit = jcommon.build_unet(jcfg, None)
    want = bridge.unet_state_dict(jp, cfg)
    unet = pcommon.build_unet(cfg, str(tmp_path), device="cpu", seed=4)
    got = _np_sd(unet)
    fresh = _fresh_keys(want, bridge.unet_state_dict(jinit, cfg))
    assert fresh == {k for k in got if k.startswith("conv_in.")
                     or ".motion_modules." in k}
    for k in set(want) - fresh:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    _match_fresh(unet, fresh, want)
    sample, ctx = _x(0, 1, 5, 8, 8, 9), _x(1, 1, 5, 7, 24)
    t = np.array([500], np.int32)
    ref = _apply(junet.StoryUNet(jcfg), jp["params"], sample, t, ctx)
    with torch.no_grad():
        out = unet(torch.from_numpy(sample), torch.from_numpy(t),
                   torch.from_numpy(ctx))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
