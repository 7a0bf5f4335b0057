"""The port's configs and parameter bridge against the JAX package, and
the port's ground rules: no import of jax or ditto_tts_tpu, entry points
that raise without CUDA, kernel wrappers with no CPU fallback."""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest

import jax
import torch

from ditto_tts_tpu.core import config as jconfig
from ditto_tts_tpu.models import dit as jdit
from ditto_tts_tpu.text import gpt2 as gpt2_mod

from ditto_tts_tpu_torch import config as tconfig
from ditto_tts_tpu_torch import kernels
from ditto_tts_tpu_torch.params import (FIELDS, fill_spec, from_jax_params,
                                        generator_spec, tree_leaves)

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


def test_entry_points_need_cuda_unless_cpu_is_asked():
    from ditto_tts_tpu_torch import resolve_device
    from ditto_tts_tpu_torch.infer.generator import (
        build_synthesize_pipelined, build_synthesize_recorded)
    tc = tconfig.PipelineConfig.from_json(CFG.to_json())
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    for build in (build_synthesize_pipelined, build_synthesize_recorded):
        with pytest.raises(RuntimeError, match="CUDA"):
            build(tc)
        build(tc, device="cpu")


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
