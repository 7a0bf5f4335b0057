"""The port's configs and parameter bridge against the JAX package, and
the port's ground rules: no import of jax or ditto_tts_tpu, entry points
that raise without CUDA, kernel wrappers with no CPU fallback."""

import ast
import dataclasses
import hashlib
import os
import pathlib

import numpy as np
import pytest

import jax
import torch

from ditto_tts_tpu.core import config as jconfig
from ditto_tts_tpu.models import dit as jdit
from ditto_tts_tpu.models import slp as jslp
from ditto_tts_tpu.text import byt5 as jbyt5
from ditto_tts_tpu.text import gpt2 as gpt2_mod

from ditto_tts_tpu_torch import config as tconfig
from ditto_tts_tpu_torch import kernels
from ditto_tts_tpu_torch.params import (FIELDS, SLP_FIELDS, byt5_spec,
                                        fill_spec, from_jax_params,
                                        generator_spec, init_slp_params,
                                        slp_spec, tree_leaves)
from ditto_tts_tpu_torch.text import byt5 as tbyt5

from _torch_port_util import CFG, jax_generator_params, jax_init_params, \
    numpy_tree, port_params

REPO = pathlib.Path(__file__).resolve().parent.parent
CONFIGS = ["AudioConfig", "CodecConfig", "NACConfig", "SLPConfig",
           "DiTConfig", "VocoderConfig", "SamplerConfig", "MeshConfig",
           "DataConfig", "PipelineConfig"]


@pytest.mark.parametrize("name", CONFIGS)
def test_config_json_equals_jax(name):
    jc, tc = getattr(jconfig, name)(), getattr(tconfig, name)()
    assert tc.to_json() == jc.to_json()
    assert [f.name for f in dataclasses.fields(tc)] == \
        [f.name for f in dataclasses.fields(jc)]
    back = type(tc).from_json(jc.to_json())
    assert back.to_json() == tc.to_json()
    assert dataclasses.asdict(back) == dataclasses.asdict(
        type(jc).from_json(jc.to_json()))


def test_byt5_config_equals_jax():
    """ByT5Config lives in the port's config.py (params.py reads no model
    module) with the JAX text/byt5.py fields and defaults; text.byt5 still
    exports it."""
    jc, tc = jbyt5.byt5_small_config(), tconfig.byt5_small_config()
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.inner_dim == jc.inner_dim
    assert tbyt5.ByT5Config is tconfig.ByT5Config


def test_config_json_roundtrip_nondefault():
    jc = CFG
    tc = tconfig.PipelineConfig.from_json(jc.to_json())
    assert tc.to_json() == jc.to_json()
    assert tc.codec.hop_length == jc.codec.hop_length
    assert tc.dit.head_dim == jc.dit.head_dim
    assert tc.audio.max_latent_frames == jc.audio.max_latent_frames


def test_from_jax_params_keeps_every_leaf():
    jp = jax_generator_params()
    # one field from the JAX package's own init, the rest numpy-drawn
    jp.dit = jax.jit(jdit.init_ditto, static_argnums=1)(
        jax.random.key(0), CFG.dit)
    want = numpy_tree(jp)
    got = port_params(jp)
    for f in FIELDS:
        wl = list(tree_leaves(want[f]))
        gl = list(tree_leaves(getattr(got, f)))
        assert [p for p, _ in wl] == [p for p, _ in gl], f
        for (path, w), (_, g) in zip(wl, gl):
            assert isinstance(g, torch.Tensor), path
            assert tuple(g.shape) == w.shape, path
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{f}{path}")


def _init(seed, gpt2_layers):
    """init_generator_params with a shallow GPT2 stack."""
    tc = tconfig.PipelineConfig.from_json(CFG.to_json())
    return from_jax_params(fill_spec(
        generator_spec(tc, gpt2_layers=gpt2_layers), seed))


def test_init_generator_params_has_the_jax_trees():
    """Same structure and shapes as the JAX inits (the GPT2 tree at the
    default GPT2Config vocabulary and positions, at the NAC width)."""
    gcfg = gpt2_mod.GPT2Config(n_embd=CFG.nac.hidden_size, n_layer=2)
    shapes = jax.eval_shape(lambda: jax_init_params(gpt2_cfg=gcfg))
    want = {f: jax.tree_util.tree_map(lambda s: s.shape, getattr(shapes, f))
            for f in FIELDS}
    got = _init(3, 2)
    for f in FIELDS:
        gl = [(p, tuple(t.shape)) for p, t in tree_leaves(getattr(got, f))]
        assert gl == _shape_leaves(want[f]), f


def _shape_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _shape_leaves(tree[k], f"{prefix}/{k}")
        return out
    if isinstance(tree, list):
        out = []
        for i, v in enumerate(tree):
            out += _shape_leaves(v, f"{prefix}/{i}")
        return out
    return [(prefix, tuple(tree))]


def _spec_shapes(spec, prefix=""):
    """(path, shape) of a leaf-spec tree, in tree_leaves' order."""
    if isinstance(spec, dict):
        return [x for k in sorted(spec)
                for x in _spec_shapes(spec[k], f"{prefix}/{k}")]
    if isinstance(spec, list):
        return [x for i, v in enumerate(spec)
                for x in _spec_shapes(v, f"{prefix}/{i}")]
    return [(prefix, spec[0])]


@pytest.mark.parametrize("byt5_cfg,slp_cfg,codebook", [
    (jbyt5.byt5_small_config(), jconfig.SLPConfig(), 1024),
    (jbyt5.ByT5Config(vocab_size=40, d_model=16, d_kv=4, d_ff=32,
                      num_layers=2, num_heads=2),
     jconfig.SLPConfig(embedding_dim=16, num_layers=2, num_heads=2), 16)],
    ids=["full_width", "tiny"])
def test_byt5_and_slp_specs_have_the_jax_trees(byt5_cfg, slp_cfg, codebook):
    """byt5_spec / slp_spec against jax.eval_shape of init_byt5 /
    init_slp_trainable (the decoder's FF at embedding_dim * num_heads)."""
    key = jax.random.key(0)
    for spec, init in (
            (byt5_spec(tbyt5.ByT5Config(**dataclasses.asdict(byt5_cfg))),
             lambda: jbyt5.init_byt5(key, byt5_cfg)),
            (slp_spec(tconfig.SLPConfig.from_json(slp_cfg.to_json()),
                      codebook),
             lambda: jslp.init_slp_trainable(key, slp_cfg, codebook))):
        want = jax.tree_util.tree_map(lambda s: s.shape,
                                      jax.eval_shape(init))
        assert _spec_shapes(spec) == _shape_leaves(want)


# sha256 of fill_spec(generator_spec(CFG, gpt2_layers=1), 0), every leaf's
# path and bytes in tree_leaves order, as the seeded draws stood before the
# ByT5 and SLP trees were added
SERVING_DRAWS_SHA256 = \
    "48b30d119f94aeca4151d62be1e6499bc9ddb1bec3827279f93b5b01250c83d5"


def test_serving_draws_unchanged_by_the_slp_trees():
    """The six serving fields keep their seeded values: ByT5 and SLP draw
    from their own fill_spec call (init_slp_params)."""
    tc = tconfig.PipelineConfig.from_json(CFG.to_json())
    h = hashlib.sha256()
    for path, a in tree_leaves(fill_spec(generator_spec(tc, gpt2_layers=1),
                                         0)):
        h.update(path.encode())
        h.update(np.ascontiguousarray(a).tobytes())
    assert h.hexdigest() == SERVING_DRAWS_SHA256
    got = _init(0, 1)
    assert got.byt5 is None and got.slp is None
    small = tbyt5.ByT5Config(vocab_size=40, d_model=16, d_kv=4, d_ff=32,
                             num_layers=1, num_heads=2)
    extra = init_slp_params(tc, seed=1, byt5_cfg=small)
    again = init_slp_params(tc, seed=1, byt5_cfg=small)
    # RMS weights start at 1, as init_byt5's
    assert torch.equal(extra["byt5"]["final_norm"]["weight"], torch.ones(16))
    for f in SLP_FIELDS:
        for (pa, a), (_, b) in zip(tree_leaves(extra[f]),
                                   tree_leaves(again[f])):
            assert torch.equal(a, b), pa
    full = dataclasses.replace(got, **extra)
    moved = full.to("cpu")
    for f in FIELDS + SLP_FIELDS:
        assert [p for p, _ in tree_leaves(getattr(moved, f))] == \
            [p for p, _ in tree_leaves(getattr(full, f))], f


def test_from_jax_params_carries_byt5_and_slp():
    tc = tconfig.PipelineConfig.from_json(CFG.to_json())
    jp = jax_generator_params()
    extra = fill_spec({"byt5": byt5_spec(tbyt5.ByT5Config(
        vocab_size=40, d_model=16, d_kv=4, d_ff=32, num_layers=1,
        num_heads=2)), "slp": slp_spec(tc.slp, tc.codec.codebook_size)}, 2)
    jp = dataclasses.replace(jp, byt5=extra["byt5"], slp=extra["slp"])
    got = port_params(jp)
    for f in SLP_FIELDS:
        want = list(tree_leaves(extra[f]))
        gl = list(tree_leaves(getattr(got, f)))
        assert [p for p, _ in gl] == [p for p, _ in want]
        for (path, g), (_, w) in zip(gl, want):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f + path)
    assert port_params(jax_generator_params()).slp is None


def test_init_generator_params_is_seeded():
    a, b, c = _init(1, 1), _init(1, 1), _init(2, 1)
    wa = a.dit["proj_in"]["weight"]
    assert torch.equal(wa, b.dit["proj_in"]["weight"])
    assert not torch.equal(wa, c.dit["proj_in"]["weight"])
    # layer norms start at ones/zeros and snake params at zeros, as in JAX
    assert torch.equal(a.dit["blocks"][0]["norm1"]["weight"],
                       torch.ones(CFG.dit.hidden_dim))
    assert not a.vocoder["act_post"]["alpha"].any()


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _port_files():
    files = sorted((REPO / "ditto_tts_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    return files


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "ditto_tts_tpu", "flax"), \
            f"{path.name} imports {mod}"


def test_import_check_covers_the_training_modules():
    names = {str(p.relative_to(REPO)) for p in _port_files()}
    assert {"ditto_tts_tpu_torch/models/nac.py",
            "ditto_tts_tpu_torch/train/steps.py",
            "ditto_tts_tpu_torch/train/checkpoint.py",
            "ditto_tts_tpu_torch/train/trainer.py",
            "ditto_tts_tpu_torch/data/mls.py",
            "ditto_tts_tpu_torch/data/latents.py",
            "ditto_tts_tpu_torch/data/native_loader.py",
            "ditto_tts_tpu_torch/data/processing.py",
            "ditto_tts_tpu_torch/scripts/_common.py",
            "ditto_tts_tpu_torch/scripts/train_ditto.py",
            "ditto_tts_tpu_torch/utils/weights.py",
            "ditto_tts_tpu_torch/assets/__init__.py"} <= names


def test_the_test_helper_sets_one_cpu_thread():
    """tests/_torch_port_util.py's thread policy: one torch thread in the
    test process (this file imports it), and ``OMP_NUM_THREADS=1`` for
    every process it starts."""
    assert torch.get_num_threads() == 1
    assert os.environ["OMP_NUM_THREADS"] == "1"


def test_gpt2_config_equals_jax():
    """The port's GPT2Config (the train step reads n_positions) has the
    JAX dataclass's fields and defaults."""
    from ditto_tts_tpu.text.gpt2 import GPT2Config
    assert dataclasses.asdict(tconfig.GPT2Config()) == \
        dataclasses.asdict(GPT2Config())


def test_entry_points_need_cuda_unless_cpu_is_asked():
    from ditto_tts_tpu_torch import resolve_device
    from ditto_tts_tpu_torch.infer.generator import (
        build_synthesize, build_synthesize_pipelined,
        build_synthesize_recorded, build_synthesize_with_slp)
    tc = tconfig.PipelineConfig.from_json(CFG.to_json())
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    for build in (build_synthesize_pipelined, build_synthesize_recorded,
                  build_synthesize, build_synthesize_with_slp):
        with pytest.raises(RuntimeError, match="CUDA"):
            build(tc)
        build(tc, device="cpu")
    # training: the step builders, the seeded train states, the frozen
    # trees, the latent precompute and the CLIs
    from ditto_tts_tpu_torch.data.latents import precompute
    from ditto_tts_tpu_torch.params import (
        init_dit_train_state, init_nac_frozen, init_nac_train_state,
        init_slp_frozen, init_slp_train_state)
    from ditto_tts_tpu_torch.scripts import train_ditto, train_nac, train_slp
    from ditto_tts_tpu_torch.train.steps import (
        build_ditto_train_step, build_nac_train_step, build_slp_train_step)
    dit = tc.dit.replace(num_layers=1)
    gpt2 = tconfig.GPT2Config(vocab_size=32, n_positions=64,
                              n_embd=tc.nac.hidden_size, n_layer=1)
    byt5 = tconfig.ByT5Config(vocab_size=40, d_model=16, d_kv=4, d_ff=32,
                              num_layers=1, num_heads=2)
    for build in (lambda **kw: build_ditto_train_step(
                      dit, tc.codec, tconfig.GPT2Config(), **kw),
                  lambda **kw: init_dit_train_state(dit, **kw),
                  lambda **kw: build_nac_train_step(tc.nac, tc.codec, gpt2,
                                                    **kw),
                  lambda **kw: build_slp_train_step(tc.slp, tc.codec, byt5,
                                                    **kw),
                  lambda **kw: init_nac_train_state(tc.nac, **kw),
                  lambda **kw: init_slp_train_state(tc.slp, 16, **kw),
                  lambda **kw: init_nac_frozen(tc.codec, gpt2, **kw),
                  lambda **kw: init_slp_frozen(tc.codec, byt5, **kw)):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
        build(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        precompute(None, None, tc.codec, cache_dir="unused")
    for cli in (train_nac, train_slp, train_ditto):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["--train-path", "unused"])


def test_frozen_trees_draw_only_what_is_not_given():
    """``init_nac_frozen`` / ``init_slp_frozen`` with ``given`` trees (the
    CLIs' imported weights) keep them as they are and draw only the
    others; with nothing given they are one draw over every tree."""
    from ditto_tts_tpu_torch.params import (_codec_spec, fill_spec,
                                            init_nac_frozen, init_slp_frozen,
                                            tree_leaves, tree_map)
    tc = tconfig.PipelineConfig.from_json(CFG.to_json())
    gpt2 = tconfig.GPT2Config(vocab_size=32, n_positions=64,
                              n_embd=tc.nac.hidden_size, n_layer=1)
    byt5 = tconfig.ByT5Config(vocab_size=40, d_model=16, d_kv=4, d_ff=32,
                              num_layers=1, num_heads=2)

    def equal(a, b):
        la, lb = tree_leaves(a), tree_leaves(b)
        return [p for p, _ in la] == [p for p, _ in lb] and all(
            torch.equal(x, y) for (_, x), (_, y) in zip(la, lb))

    full = init_nac_frozen(tc.codec, gpt2, seed=3, device="cpu")
    marker = {"wte": torch.full((2, 2), 7.0)}
    part = init_nac_frozen(tc.codec, gpt2, seed=3, device="cpu",
                           given={"gpt2": marker})
    assert list(part) == ["codec", "gpt2"] and part["gpt2"] is not marker
    assert equal(part["gpt2"], marker) and equal(part["codec"], full["codec"])
    # the SLP's codec sorts after ByT5: given ByT5, the codec is the first
    # draw of the seed
    slp = init_slp_frozen(tc.codec, byt5, seed=3, device="cpu",
                          given={"byt5": marker})
    want = tree_map(torch.from_numpy, fill_spec(_codec_spec(tc.codec), 3))
    assert equal(slp["byt5"], marker) and equal(slp["codec"], want)
    both = init_slp_frozen(tc.codec, byt5, seed=3, device="cpu",
                           given={"byt5": marker, "codec": full["codec"]})
    assert equal(both["codec"], full["codec"])


def test_kernel_wrappers_have_no_cpu_fallback():
    """The CUDA wrappers refuse CPU tensors (the plain versions are chosen
    one level up, by the tensor's device) and count no launch."""
    from ditto_tts_tpu_torch.ops.act_conv import aa_snake_conv1d_cuda
    from ditto_tts_tpu_torch.ops.attention import attention_cuda
    from ditto_tts_tpu_torch.ops.conv import conv1d_cuda
    before = dict(kernels.launches)
    q = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError, match="CUDA"):
        attention_cuda(q, q, q)
    x, w = torch.zeros(1, 4, 32), torch.zeros(4, 4, 3)
    with pytest.raises(ValueError, match="CUDA"):
        conv1d_cuda(x, w)
    with pytest.raises(ValueError, match="CUDA"):
        aa_snake_conv1d_cuda(x, torch.ones(4), torch.ones(4), w)
    assert kernels.launches == before
